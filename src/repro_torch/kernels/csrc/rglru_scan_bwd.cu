// Backward of the RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the TPU kernel src/repro/kernels/rglru_scan.py
// has no backward.  The reference trains through the XLA scan that its
// models run, src/repro/models/mamba.py _chunked_scan (which
// src/repro/models/rglru.py calls), and JAX differentiates it.
//
//   a        [B, S, W] float   decay (a = 1 on pad lanes)
//   hs       [B, S, W] float   the forward's states
//   h0       [B, W]    float   state before token 0
//   dhs      [B, S, W] float   gradient of hs
//   dh_last  [B, W]    float   gradient of the state after token S - 1
//   da, db   [B, S, W] float   out
//   dh0      [B, W]    float   out
//
//   g_t = dhs_t + a_{t+1} g_{t+1}   (g_{S-1} = dhs_{S-1} + dh_last)
//   da_t = g_t h_{t-1} (h_{-1} = h0),  db_t = g_t,  dh0 = a_0 g_0
//
// What bounds it on the H100: device-memory bytes.  Each element of a, hs
// and dhs is read once and each of da and db written once, 20 bytes, with
// one add and two multiplies: at recurrentgemma-9b's training shape (B 8,
// S 256, W 4096) that is 168 MB, 50 us at 3.35 TB/s.
//
// What the design does about it: one thread per (b, w) carries g in a
// register backwards through the sequence, so the sum keeps the plain
// version's order; the multiplies and the add are rounded separately (no
// fused multiply-add), in the plain version's order, so the two agree bit
// for bit.  hs is the forward's own output: nothing is recomputed.  Each
// thread loads a tile of kTile steps of a, dhs and h_{t-1} into registers
// before the chain runs over it, so a tile's loads are in flight together;
// every load and store is coalesced along w.  Blocks of 256 channels,
// B * W / 256 of them (128 at the training shape).  What holds it back:
// the next tile's loads do not overlap the current tile's chain.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // width channels a block
constexpr int kTile = 16;      // steps a thread holds in registers at once

__global__ void __launch_bounds__(kThreads)
    rglru_scan_bwd_kernel(const float* __restrict__ a,
                          const float* __restrict__ hs,
                          const float* __restrict__ h0,
                          const float* __restrict__ dhs,
                          const float* __restrict__ dh_last,
                          float* __restrict__ da, float* __restrict__ db,
                          float* __restrict__ dh0, int S, int W) {
  const int row = blockIdx.y;
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t state = static_cast<size_t>(row) * W + w;
  const size_t base = static_cast<size_t>(row) * S * W + w;
  float carry = dh_last[state];  // a_{t+1} g_{t+1}
  // tiles [t1 - kTile, t1) from the end; the first one may be partial
  for (int t1 = S; t1 > 0; t1 -= kTile) {
    float ra[kTile], rd[kTile], rh[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const int t = t1 - 1 - i;
      if (t >= 0) {
        const size_t o = base + static_cast<size_t>(t) * W;
        ra[i] = a[o];
        rd[i] = dhs[o];
        rh[i] = t > 0 ? hs[o - W] : h0[state];
      }
    }
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const int t = t1 - 1 - i;
      if (t >= 0) {
        const size_t o = base + static_cast<size_t>(t) * W;
        const float g = __fadd_rn(rd[i], carry);
        da[o] = __fmul_rn(g, rh[i]);
        db[o] = g;
        carry = __fmul_rn(ra[i], g);
      }
    }
  }
  dh0[state] = carry;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).
extern "C" int rglru_scan_bwd(const void* a, const void* hs, const void* h0,
                              const void* dhs, const void* dh_last, void* da,
                              void* db, void* dh0, int B, int S, int W,
                              void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return cudaErrorInvalidValue;
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_bwd_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(hs),
      static_cast<const float*>(h0), static_cast<const float*>(dhs),
      static_cast<const float*>(dh_last), static_cast<float*>(da),
      static_cast<float*>(db), static_cast<float*>(dh0), S, W);
  return cudaGetLastError();
}

// Readable name of a CUDA error code returned by a launch function.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
