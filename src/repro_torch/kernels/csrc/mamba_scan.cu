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
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
//
// A pad lane with dt = 0 is the identity: exp(0) = 1 and 0 * x * B = 0, so
// h is exactly the state after the last valid token.
//
// What bounds it on the H100: at falcon-mamba-7b's mixed step (B 8, S 32,
// D 8192, N 16) the call must move dt, x and y (8.4 MB each in float) and
// h0 and h (4.2 MB each): about 29 MB, 9 us at 3.35 TB/s.  It also takes
// B * S * D * N = 33.5 M exponentials, which the SFU (16 a clock per SM)
// does in about 8 us: the two bounds are close, and the FMA work (three
// per exponential) is a third of either.
//
// What the design does about it: one thread per (b, d) channel keeps its N
// states in registers for the whole sequence, so the state is read once
// and written once; dt, x and y are read and written coalesced along d; a
// block of 256 channels stages Bm and Cm rows, which every channel of a
// request shares, through shared memory 32 time steps at a time.  The
// recurrence is sequential in t within a thread; B * D / 256 blocks (256
// at falcon's shape) cover the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // d channels per block
constexpr int kTile = 32;      // time steps of Bm and Cm staged at once

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename TX, int N>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const TX* __restrict__ x, const float* __restrict__ A,
                      const float* __restrict__ Dsk,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_out, int S, int D) {
  __shared__ float b_s[kTile][N];
  __shared__ float c_s[kTile][N];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < D;

  float h[N], a_row[N];
  float dsk = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = a_row[n] = 0.f;
  if (live) {
    const float* h0r = h0 + (static_cast<size_t>(b) * D + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      h[n] = h0r[n];
      a_row[n] = A[static_cast<size_t>(d) * N + n];
    }
    dsk = Dsk[d];
  }

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int nt = min(kTile, S - t0);
    __syncthreads();  // the previous tile has been consumed
    for (int i = threadIdx.x; i < nt * N; i += kThreads) {
      const size_t src = (static_cast<size_t>(b) * S + t0) * N + i;
      b_s[i / N][i % N] = Bm[src];
      c_s[i / N][i % N] = Cm[src];
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < nt; ++tt) {
      const size_t off = (static_cast<size_t>(b) * S + t0 + tt) * D + d;
      const float dtv = dt[off];
      const float xv = to_float(x[off]);
      const float dx = dtv * xv;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dtv * a_row[n]) * h[n] + dx * b_s[tt][n];
        acc += h[n] * c_s[tt][n];
      }
      y[off] = acc + dsk * xv;
    }
  }

  if (live) {
    float* hr = h_out + (static_cast<size_t>(b) * D + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) hr[n] = h[n];
  }
}

template <typename TX, int N>
cudaError_t launch(const void* dt, const void* Bm, const void* Cm,
                   const void* x, const void* A, const void* Dsk,
                   const void* h0, void* y, void* h, int B, int S, int D,
                   cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  mamba_scan_kernel<TX, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const TX*>(x),
      static_cast<const float*>(A), static_cast<const float*>(Dsk),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h), S, D);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t by_state(const void* dt, const void* Bm, const void* Cm,
                     const void* x, const void* A, const void* Dsk,
                     const void* h0, void* y, void* h, int B, int S, int D,
                     int N, cudaStream_t stream) {
  switch (N) {
    case 4: return launch<TX, 4>(dt, Bm, Cm, x, A, Dsk, h0, y, h, B, S, D,
                                 stream);
    case 8: return launch<TX, 8>(dt, Bm, Cm, x, A, Dsk, h0, y, h, B, S, D,
                                 stream);
    case 16: return launch<TX, 16>(dt, Bm, Cm, x, A, Dsk, h0, y, h, B, S, D,
                                   stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x_dtype: 0 = float x, 1 = bf16 x (every other operand is float).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int mamba_scan(int x_dtype, const void* dt, const void* Bm,
                          const void* Cm, const void* x, const void* A,
                          const void* Dsk, const void* h0, void* y, void* h,
                          int B, int S, int D, int N, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: return by_state<float>(dt, Bm, Cm, x, A, Dsk, h0, y, h, B, S, D,
                                   N, st);
    case 1: return by_state<__nv_bfloat16>(dt, Bm, Cm, x, A, Dsk, h0, y, h,
                                           B, S, D, N, st);
    default: return cudaErrorInvalidValue;
  }
}

// Readable name of a CUDA error code returned by a launch function.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
