// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py (rglru_scan, body
// _rglru_kernel), whose grid (B, W / bw) gives each program a width tile
// and scans time sequentially in VMEM.
//
//   a, b  [B, S, W] float   decay and gated input (a = 1, b = 0 on pad lanes)
//   h0    [B, W]    float   state before token 0
//   hs    [B, S, W] float   out: the state after every token
//   h     [B, W]    float   out: the state after token S - 1
//
// What bounds it on the H100: device-memory bytes.  Each element of a and
// b is read once and each of hs written once, with one multiply and one
// add in between: at recurrentgemma-9b's mixed step (B 8, S 32, W 4096)
// that is 12.6 MB of a, b and hs plus 0.26 MB of state, about 3.8 us at
// 3.35 TB/s, against 2 M operations.  At its full-sequence prefill (B 4,
// S 4096, W 4096) it is 805 MB, 240 us.
//
// What the design does about it: one thread per (b, w) carries h in a
// register across the sequence, so the recurrence keeps the plain
// version's order; the multiply and the add are rounded separately (no
// fused multiply-add), as the plain PyTorch version rounds them, so the
// two agree bit for bit.  The bytes in flight come from the loads, not
// from the block shape (blocks of 256 channels, B * W / 256 of them):
// * each thread loads a tile of kTile steps of a and b into registers
//   before the chain of multiply-adds runs (at S <= 32, the whole call),
//   and loads the next tile while it runs the current one, so that a long
//   sequence keeps 2 * kTile steps of loads in flight per channel; every
//   load and store is coalesced along w and the stores of hs stream out
//   as the chain produces them;
// * the decode step (S = 1) takes a branch at the top that does its one
//   multiply-add without the tiles, and a partial tile runs in runs of 8
//   steps that stop past S, so that a short call runs short code.
// What holds it back now: at S <= 32 the call is a launch and one round
// trip of loads; at the full-sequence prefill (B 4) the 64 blocks leave
// half of the 132 SMs without work, and each of their threads has at most
// two 32-step tiles of loads in flight.  Times on the card are in PERF.md
// (chip_smoke.py, scripts/scan_ab.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // width channels a block
constexpr int kTile = 32;      // steps of a and b a thread holds at once

// Steps [t0, t0 + n) of a and b into registers, n = min(kTile, S - t0): a
// whole tile unrolled without a test; a partial one in runs of 8 steps,
// stopping at the first run past n, so that a short call runs short code.
__device__ __forceinline__ void load_tile(const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          size_t base, int t0, int S, int W,
                                          float (&ra)[kTile],
                                          float (&rb)[kTile]) {
  const int n = min(kTile, S - t0);
  const float* at = a + base + static_cast<size_t>(t0) * W;
  const float* bt = b + base + static_cast<size_t>(t0) * W;
  if (n == kTile) {
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      ra[i] = at[static_cast<size_t>(i) * W];
      rb[i] = bt[static_cast<size_t>(i) * W];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      if (i % 8 == 0 && i >= n) break;
      if (i < n) {
        ra[i] = at[static_cast<size_t>(i) * W];
        rb[i] = bt[static_cast<size_t>(i) * W];
      }
    }
  }
}

// Steps [t0, t0 + n) of the chain from registers, as load_tile splits them.
__device__ __forceinline__ float run_tile(const float (&ra)[kTile],
                                          const float (&rb)[kTile], float h,
                                          float* __restrict__ hs,
                                          size_t base, int t0, int S,
                                          int W) {
  const int n = min(kTile, S - t0);
  float* ht = hs + base + static_cast<size_t>(t0) * W;
  if (n == kTile) {
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      h = __fadd_rn(__fmul_rn(ra[i], h), rb[i]);
      ht[static_cast<size_t>(i) * W] = h;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      if (i % 8 == 0 && i >= n) break;
      if (i < n) {
        h = __fadd_rn(__fmul_rn(ra[i], h), rb[i]);
        ht[static_cast<size_t>(i) * W] = h;
      }
    }
  }
  return h;
}

__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ hs,
                      float* __restrict__ h_out, int S, int W) {
  const int row = blockIdx.y;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  float h = h0[static_cast<size_t>(row) * W + w];
  const size_t base = static_cast<size_t>(row) * S * W + w;
  if (S == 1) {  // the decode step: one multiply-add, no register tiles
    h = __fadd_rn(__fmul_rn(a[base], h), b[base]);
    hs[base] = h;
    h_out[static_cast<size_t>(row) * W + w] = h;
    return;
  }
  // two register tiles in turn: one is loading while the other runs
  float a0[kTile], b0[kTile], a1[kTile], b1[kTile];
  load_tile(a, b, base, 0, S, W, a0, b0);
  for (int t0 = 0; t0 < S; t0 += 2 * kTile) {
    if (t0 + kTile < S) load_tile(a, b, base, t0 + kTile, S, W, a1, b1);
    h = run_tile(a0, b0, h, hs, base, t0, S, W);
    if (t0 + kTile >= S) break;
    if (t0 + 2 * kTile < S) {
      load_tile(a, b, base, t0 + 2 * kTile, S, W, a0, b0);
    }
    h = run_tile(a1, b1, h, hs, base, t0 + kTile, S, W);
  }
  h_out[static_cast<size_t>(row) * W + w] = h;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).
extern "C" int rglru_scan(const void* a, const void* b, const void* h0,
                          void* hs, void* h, int B, int S, int W,
                          void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return cudaErrorInvalidValue;
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(hs),
      static_cast<float*>(h), S, W);
  return cudaGetLastError();
}

// Readable name of a CUDA error code returned by a launch function.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
