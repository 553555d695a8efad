// Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan.py (mamba_scan, body
// _mamba_kernel), whose grid (B, D / bd) gives each program a d_inner tile
// and scans time sequentially in VMEM.
//
//   dt   [B, S, D] float    post-softplus step sizes (0 on pad lanes)
//   Bm   [B, S, N] float    input matrix rows
//   Cm   [B, S, N] float    output matrix rows
//   x    [B, S, D] float or bf16   post-conv activations
//   A    [D, N]    float    state matrix (negative)
//   Dsk  [D]       float    skip connection
//   h0   [B, D, N] float    state before token 0
//   y    [B, S, D] float    out: h_t . C_t + Dsk * x_t
//   h    [B, D, N] float    out: state after token S - 1
//   states [B, ceil(S / kStateTile), D, N] float   out, optional (null:
//            not written): the state before every kStateTile-step tile,
//            which the backward kernel (mamba_scan_bwd.cu) starts each of
//            its tiles from; entry 0 is h0
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
//
// A pad lane with dt = 0 is the identity: 2^0 = 1 exactly (ex2.approx is
// exact there) and 0 * x * B = 0, so h is exactly the state after the last
// valid token.
//
// What bounds it on the H100: at falcon-mamba-7b's mixed step (B 8, S 32,
// D 8192, N 16) the call must move dt and y (8.4 MB each in float), x (4.2
// MB in bf16) and h0 and h (4.2 MB each): about 29 MB, 9 us at 3.35 TB/s.
// It also takes B * S * D * N = 33.5 M exponentials, which the SFU (16 a
// clock per SM) does in about 8 us: the two bounds are close, and the FMA
// work (four per exponential) is half of either.  At the decode step (S 1)
// the 8.4 MB of state in and out is nearly all of it: 2.9 us.
//
// What the design does about it (times on the card are in PERF.md, from
// chip_smoke.py and scripts/scan_ab.py):
// * a channel's N states are spread over kLanes lanes (2 at N 8 and 16, 1
//   at N 4), each lane holding whole float4 groups of 4 states: lane j
//   of a channel holds groups j, j + kLanes, ...  So every warp-wide
//   float4 load of h0 and A and store of h covers whole 32-byte sectors,
//   and the decode step has twice the warps of one lane a channel;
// * a block of kChannels channels stages a tile of kTile steps of dt, x,
//   Bm and Cm in shared memory by cp.async, in kStages groups of kSub
//   steps that are all in flight before the chain of updates starts (at
//   S <= 32 the tile is the whole call); the chain runs each group as soon
//   as it lands, while the later ones are still arriving.  A width that
//   is not a multiple of 8 stages through registers instead (every
//   operand is 16-byte aligned: the wrapper rejects any other);
// * exp(dt * A) is ex2.approx of dt * (A log2 e), with A scaled once per
//   lane: one SFU operation and no range reduction (the exponent is at
//   most about 16 in magnitude, where its relative error is about 1e-6);
// * each lane adds h . C over its own states, in state order, and the two
//   lanes of a channel add their partial sums with one __shfl_xor_sync,
//   which gives both lanes the same sum; the even lane puts y in place of
//   the step's dt in shared memory, and the block stores each group's y
//   coalesced once the next group has started;
// * a whole group's steps are unrolled, so that every shared-memory offset
//   is a constant and no step pays for address arithmetic or a branch;
// * under training the lanes also store their states at each kStateTile
//   boundary, from the registers that hold them (67 MB a call at the
//   training shape B 8, S 256, D 8192, N 16); serving passes no `states`
//   and stores nothing.  The arithmetic is the same either way, so y and h
//   are the same bits with and without.
// The recurrence stays sequential in t; B * ceil(D / 64) blocks (1024 at
// falcon's shape, eight of 128 threads an SM, 64 registers) cover the
// card in one wave.  What holds it back now: each step of a lane's 8
// states issues 8 exponentials and 32 multiplies and multiply-adds besides
// its shared-memory reads and the shuffle, so the chain alone is bound by
// instruction issue and the SFU at about 8 us, and the first group's loads
// and the last group's stores do not overlap it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mamba_tile.cuh"

namespace {

constexpr int kChannels = 64;  // d channels of a block
constexpr int kTile = 32;      // time steps staged in shared memory at once
constexpr int kSub = 8;        // steps of a pipeline stage of the tile
constexpr int kStages = kTile / kSub;
// steps between kept states (mamba_tile.cuh; a multiple of kSub)
constexpr int kStateTile = mamba::kStateTile;
static_assert(kTile % kStateTile == 0 && kStateTile % kSub == 0,
              "a kept state falls at the start of a stage");
constexpr float kLog2e = 1.4426950408889634f;

template <int N>
struct Geometry {
  static constexpr int kLanes = N == 4 ? 1 : 2;        // lanes a channel
  static constexpr int kGroups = N / 4 / kLanes;       // float4s a lane
  static constexpr int kThreads = kChannels * kLanes;  // threads a block
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes from global to shared memory without a register, or (full =
// false) 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until the first s + 1 of kStages committed groups have landed.
__device__ __forceinline__ void cp_async_wait_stage(int s) {
  switch (kStages - 1 - s) {  // a constant once the stage loop is unrolled
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Rows [t_lo, t_lo + kSub) of a [B, S, W] array at (b, t0), columns [w0,
// w0 + kCols), into dst[kTile][kCols] by 16-byte chunks; rows at or past
// nt and columns at or past W are zero-filled (W is a multiple of the
// chunk).
template <typename T, int kCols, int kThreads>
__device__ __forceinline__ void stage_async(T (*dst)[kCols],
                                            const T* __restrict__ src,
                                            int b, int t0, int t_lo, int nt,
                                            int S, int W, int w0) {
  constexpr int kPer = 16 / sizeof(T);           // elements a chunk
  constexpr int kRow = kCols / kPer;             // chunks a row
  constexpr int kChunks = kSub * kRow;
#pragma unroll
  for (int r = 0; r < (kChunks + kThreads - 1) / kThreads; ++r) {
    const int q = threadIdx.x + r * kThreads;
    if (kChunks % kThreads == 0 || q < kChunks) {
      const int t = t_lo + q / kRow, col = (q % kRow) * kPer;
      const bool full = t < nt && w0 + col < W;
      const T* from = full ? src + (static_cast<size_t>(b) * S + t0 + t)
                                       * W + w0 + col
                           : src;
      cp_async16(&dst[t][col], from, full);
    }
  }
}

// One step of a lane's chain: its states advance by one token, and the
// channel's y_t (the same in both lanes) is returned.
template <int N>
__device__ __forceinline__ float step(float4 (&h)[Geometry<N>::kGroups],
                                      const float4 (&a2)[Geometry<N>::kGroups],
                                      float dtv, float xv, float dsk,
                                      const float* b_row, const float* c_row,
                                      int j) {
  using G = Geometry<N>;
  const float dx = dtv * xv;
  float part = 0.f;
#pragma unroll
  for (int k = 0; k < G::kGroups; ++k) {
    const int g = j + G::kLanes * k;
    const float4 bq = reinterpret_cast<const float4*>(b_row)[g];
    const float4 cq = reinterpret_cast<const float4*>(c_row)[g];
    h[k].x = fmaf(ex2(dtv * a2[k].x), h[k].x, dx * bq.x);
    h[k].y = fmaf(ex2(dtv * a2[k].y), h[k].y, dx * bq.y);
    h[k].z = fmaf(ex2(dtv * a2[k].z), h[k].z, dx * bq.z);
    h[k].w = fmaf(ex2(dtv * a2[k].w), h[k].w, dx * bq.w);
    part = fmaf(h[k].x, cq.x, part);
    part = fmaf(h[k].y, cq.y, part);
    part = fmaf(h[k].z, cq.z, part);
    part = fmaf(h[k].w, cq.w, part);
  }
  if (G::kLanes == 2) part += __shfl_xor_sync(0xffffffffu, part, 1);
  return fmaf(dsk, xv, part);
}

// The y of rows [t_lo, t_lo + kSub) (those below nt) of a tile, which the
// even lanes left in place of dt, stored coalesced along d.
template <int kThreads>
__device__ __forceinline__ void store_y(float* __restrict__ y,
                                        const float (*y_s)[kChannels], int b,
                                        int t0, int t_lo, int nt, int S,
                                        int D, int d0) {
#pragma unroll
  for (int r = 0; r < kSub * kChannels / kThreads; ++r) {
    const int i = threadIdx.x + r * kThreads;
    const int t = t_lo + i / kChannels, cc = i % kChannels;
    if (t < nt && d0 + cc < D) {
      y[(static_cast<size_t>(b) * S + t0 + t) * D + d0 + cc] = y_s[t][cc];
    }
  }
}

template <typename TX, int N>
__global__ void __launch_bounds__(Geometry<N>::kThreads,
                                  1024 / Geometry<N>::kThreads)
    mamba_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const TX* __restrict__ x, const float* __restrict__ A,
                      const float* __restrict__ Dsk,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_out, float* __restrict__ states,
                      int S, int D, bool async) {
  using G = Geometry<N>;
  // dt in; the even lane of a channel puts the step's y in place of its dt
  // once both lanes have read it (the shuffle orders the two)
  __shared__ __align__(16) float dt_s[kTile][kChannels];
  __shared__ __align__(16) TX x_s[kTile][kChannels];
  __shared__ __align__(16) float b_s[kTile][N];
  __shared__ __align__(16) float c_s[kTile][N];
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int c = threadIdx.x / G::kLanes;   // channel within the block
  const int j = threadIdx.x % G::kLanes;   // lane within the channel
  const int d = d0 + c;
  const bool live = d < D;

  // state, A scaled to log2 units, skip; groups g = j + kLanes * k
  float4 h[G::kGroups], a2[G::kGroups];
  float dsk = 0.f;
#pragma unroll
  for (int k = 0; k < G::kGroups; ++k) {
    h[k] = a2[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < G::kGroups; ++k) {
      const int n = 4 * (j + G::kLanes * k);
      // one float4 each: the arrays are 16-byte aligned and a group starts
      // on a multiple of 4 states
      h[k] = *reinterpret_cast<const float4*>(
          h0 + (static_cast<size_t>(b) * D + d) * N + n);
      const float4 av =
          *reinterpret_cast<const float4*>(A + static_cast<size_t>(d) * N + n);
      a2[k] = make_float4(av.x * kLog2e, av.y * kLog2e, av.z * kLog2e,
                          av.w * kLog2e);
    }
    dsk = Dsk[d];
  }

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int nt = min(kTile, S - t0);
    __syncthreads();  // the previous tile has been consumed
    if (async) {      // every stage in flight at once, a group each
#pragma unroll
      for (int s = 0; s < kStages; ++s) {
        const int t_lo = s * kSub;
        if (t_lo < nt) {
          stage_async<float, kChannels, G::kThreads>(dt_s, dt, b, t0, t_lo,
                                                     nt, S, D, d0);
          stage_async<TX, kChannels, G::kThreads>(x_s, x, b, t0, t_lo, nt, S,
                                                  D, d0);
          stage_async<float, N, G::kThreads>(b_s, Bm, b, t0, t_lo, nt, S, N,
                                             0);
          stage_async<float, N, G::kThreads>(c_s, Cm, b, t0, t_lo, nt, S, N,
                                             0);
        }
        cp_async_commit();  // empty past nt: the group count stays kStages
      }
    } else {          // ragged widths: through registers, zero-filled
      for (int i = threadIdx.x; i < kTile * kChannels; i += G::kThreads) {
        const int t = i / kChannels, cc = i % kChannels;
        const bool in = t < nt && d0 + cc < D;
        const size_t off = (static_cast<size_t>(b) * S + t0 + t) * D + d0
                           + cc;
        dt_s[t][cc] = in ? dt[off] : 0.f;
        x_s[t][cc] = in ? x[off] : TX(0.f);
      }
      for (int i = threadIdx.x; i < kTile * N; i += G::kThreads) {
        const int t = i / N;
        const size_t src = (static_cast<size_t>(b) * S + t0) * N + i;
        b_s[t][i % N] = t < nt ? Bm[src] : 0.f;
        c_s[t][i % N] = t < nt ? Cm[src] : 0.f;
      }
    }
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      const int t_lo = s * kSub;
      if (t_lo >= nt) break;  // uniform across the block
      if (async) cp_async_wait_stage(s);
      __syncthreads();  // stage s has landed, stage s - 1's y is complete
      if (s > 0) {
        store_y<G::kThreads>(y, dt_s, b, t0, t_lo - kSub, nt, S, D, d0);
      }
      if (states != nullptr && t_lo % kStateTile == 0 && live) {
        // the state before step t0 + t_lo: a boundary of the backward's tiles
        const size_t row = static_cast<size_t>(b)
                           * ((S + kStateTile - 1) / kStateTile)
                           + (t0 + t_lo) / kStateTile;
#pragma unroll
        for (int k = 0; k < G::kGroups; ++k) {
          *reinterpret_cast<float4*>(
              states + (row * D + d) * N + 4 * (j + G::kLanes * k)) = h[k];
        }
      }
      if (t_lo + kSub <= nt) {  // a whole stage: every offset a constant
#pragma unroll
        for (int tt = t_lo; tt < t_lo + kSub; ++tt) {
          const float yv = step<N>(h, a2, dt_s[tt][c], to_float(x_s[tt][c]),
                                   dsk, b_s[tt], c_s[tt], j);
          if (j == 0) dt_s[tt][c] = yv;
        }
      } else {
        for (int tt = t_lo; tt < nt; ++tt) {
          const float yv = step<N>(h, a2, dt_s[tt][c], to_float(x_s[tt][c]),
                                   dsk, b_s[tt], c_s[tt], j);
          if (j == 0) dt_s[tt][c] = yv;
        }
      }
    }
    __syncthreads();
    store_y<G::kThreads>(y, dt_s, b, t0, (nt - 1) / kSub * kSub, nt, S, D, d0);
    if (async) cp_async_wait_stage(kStages - 1);  // nothing left in flight
  }

  if (live) {
#pragma unroll
    for (int k = 0; k < G::kGroups; ++k) {
      const int n = 4 * (j + G::kLanes * k);
      *reinterpret_cast<float4*>(
          h_out + (static_cast<size_t>(b) * D + d) * N + n) = h[k];
    }
  }
}

template <typename TX, int N>
cudaError_t launch(const void* dt, const void* Bm, const void* Cm,
                   const void* x, const void* A, const void* Dsk,
                   const void* h0, void* y, void* h, void* states, int B,
                   int S, int D, cudaStream_t stream) {
  const dim3 grid((D + kChannels - 1) / kChannels, B);
  const bool async = D % 8 == 0;  // every row of dt and x whole 16-byte chunks
  mamba_scan_kernel<TX, N><<<grid, Geometry<N>::kThreads, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const TX*>(x),
      static_cast<const float*>(A), static_cast<const float*>(Dsk),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h), static_cast<float*>(states), S, D, async);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t by_state(const void* dt, const void* Bm, const void* Cm,
                     const void* x, const void* A, const void* Dsk,
                     const void* h0, void* y, void* h, void* states, int B,
                     int S, int D, int N, cudaStream_t stream) {
  switch (N) {
    case 4: return launch<TX, 4>(dt, Bm, Cm, x, A, Dsk, h0, y, h, states, B,
                                 S, D, stream);
    case 8: return launch<TX, 8>(dt, Bm, Cm, x, A, Dsk, h0, y, h, states, B,
                                 S, D, stream);
    case 16: return launch<TX, 16>(dt, Bm, Cm, x, A, Dsk, h0, y, h, states,
                                   B, S, D, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x_dtype: 0 = float x, 1 = bf16 x (every other operand is float);
// states may be null.  Returns the cudaError_t of the launch (0 =
// success).
extern "C" int mamba_scan(int x_dtype, const void* dt, const void* Bm,
                          const void* Cm, const void* x, const void* A,
                          const void* Dsk, const void* h0, void* y, void* h,
                          void* states, int B, int S, int D, int N,
                          void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: return by_state<float>(dt, Bm, Cm, x, A, Dsk, h0, y, h, states,
                                   B, S, D, N, st);
    case 1: return by_state<__nv_bfloat16>(dt, Bm, Cm, x, A, Dsk, h0, y, h,
                                           states, B, S, D, N, st);
    default: return cudaErrorInvalidValue;
  }
}

// Readable name of a CUDA error code returned by a launch function.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
