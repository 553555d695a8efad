// Flash-attention backward for Hopper (sm_90a): the gradients dq, dk, dv of
// flash_attention.cu's causal grouped-query attention, with its optional
// sliding window and per-sequence lengths.
//
// Replaces no TPU kernel: the Pallas flash kernel
// (src/repro/kernels/flash_attention.py) had no backward, and the reference
// trains through XLA (_flash_attention, src/repro/models/attention.py:90),
// which JAX differentiates.  The port sends every full-sequence attention
// to the hand-written forward on the card, so training needs this kernel.
//
//   q, o, dout  [B, H, S, HD]   float or bf16 (H = K * G, HD in {32, 64,
//                               128, 256})
//   k, v        [B, K, S, HD]   same type
//   lengths     [B] int32       optional: key t is attendable iff t < len
//   lse, delta  [B, H, S] f32   scratch written by the pre-pass
//   dq          [B, H, S, HD]   type of q
//   dk, dv      [B, K, S, HD]   type of q
//
// With s = q.k / sqrt(HD) over the valid (query, key) pairs, P = softmax(s)
// and o = P v:  D = rowsum(dout * o), dP = dout v^T, dS = P * (dP - D),
// dq = dS k / sqrt(HD), dk = dS^T q / sqrt(HD) and dv = P^T dout, dk and dv
// summed over the G query heads of a kv head.  A query row with no valid
// key (lengths 0) gets zero gradients, as the forward gives it zeros.
//
// What bounds it on the H100: operations.  Each valid (query, key) pair
// costs five products of HD multiply-adds (s, dP, dq, dk, dv; 10 * HD FLOP
// with s recomputed once more in the pre-pass) against 2 * 3 * S * HD
// elements read per head: far above the ridge at the demo's S 256.
//
// What the design does about it: this first version is simple and exact,
// with fp32 FMA on the CUDA cores and fp32 accumulation whatever the input
// type (tensor cores, TMA and wgmma are later work).  Three kernels, no
// atomics, so every call gives the same bits:
//   (a) pre-pass, a block per (b, head, query tile): recomputes each row's
//       lse over its valid keys (online max and sum) and D = rowsum(do*o);
//       the forward kernels stay as they are, with no lse output;
//   (b) dk/dv, a block per (b, kv head, key tile): walks the query tiles
//       of all G heads from the tile's diagonal to its window's end,
//       accumulating dk and dv in registers;
//   (c) dq, a block per (b, head, query tile): walks the key tiles from
//       the window's start to the diagonal (capped at the length),
//       accumulating dq in registers, longest tiles first.
// Tiles of TL rows (64 at HD <= 64, 32 at 128, 16 at 256) are staged in
// shared memory as fp32 with a row stride of HD + 1, so a warp reading one
// column of K across 32 rows hits 32 banks.  A thread of a score tile owns
// one key column and TL * TL / 256 query rows; a thread of an accumulator
// owns one head-dim column and TL * HD / 256 rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int HD>
constexpr int kTile = HD >= 256 ? 16 : HD >= 128 ? 32 : 64;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const int32_t* lengths;
  float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, K, G, S, window;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Keys t < len are attendable.
__device__ __forceinline__ int key_len(const Args& a, int b) {
  return a.lengths ? min(max(a.lengths[b], 0), a.S) : a.S;
}

__device__ __forceinline__ bool attends(const Args& a, int i, int j,
                                        int len) {
  return i < a.S && j <= i && j < len && (a.window <= 0 || j > i - a.window);
}

// Rows [r0, r0 + TL) of a [S, HD] matrix into a TL x (HD + 1) fp32 tile;
// rows past S are zeros.
template <typename T, int HD, int TL>
__device__ void load_tile(float* dst, const T* src, int r0, int S) {
  for (int e = threadIdx.x; e < TL * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    dst[r * (HD + 1) + d] =
        r0 + r < S ? to_float(src[static_cast<long long>(r0 + r) * HD + d])
                   : 0.f;
  }
}

// A [i, j] entry of a score tile: thread owns column j = tid % TL and rows
// tid / TL + m * (256 / TL).
template <int TL>
constexpr int kScoreRows = TL * TL / kThreads;

// s[m] = a_i . b_j and (with c, e) t[m] = c_i . e_j over HD.
template <int HD, int TL, bool TWO>
__device__ __forceinline__ void dots(const float* a_s, const float* b_s,
                                     const float* c_s, const float* e_s,
                                     float (&s)[kScoreRows<TL>],
                                     float (&t)[kScoreRows<TL>]) {
  constexpr int M = kScoreRows<TL>, LD = HD + 1, RS = kThreads / TL;
  const int j = threadIdx.x % TL, i0 = threadIdx.x / TL;
#pragma unroll
  for (int m = 0; m < M; ++m) s[m] = t[m] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    const float bv = b_s[j * LD + d];
    const float ev = TWO ? e_s[j * LD + d] : 0.f;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      s[m] += a_s[(i0 + m * RS) * LD + d] * bv;
      if (TWO) t[m] += c_s[(i0 + m * RS) * LD + d] * ev;
    }
  }
}

// An accumulator entry [r, d]: thread owns column d = tid % HD and rows
// tid / HD + m * (256 / HD).
template <int HD, int TL>
constexpr int kAccRows = TL * HD / kThreads;

// acc[r, d] += sum_c W[r, c] x[c, d] (TRANS: W[c, r]); W is TL x (TL + 1),
// x is TL x (HD + 1).
template <int HD, int TL, bool TRANS>
__device__ __forceinline__ void accumulate(const float* w_s, const float* x_s,
                                           float (&acc)[kAccRows<HD, TL>]) {
  constexpr int M = kAccRows<HD, TL>, LD = HD + 1, RS = kThreads / HD;
  const int d = threadIdx.x % HD, r0 = threadIdx.x / HD;
#pragma unroll 4
  for (int c = 0; c < TL; ++c) {
    const float xv = x_s[c * LD + d];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int r = r0 + m * RS;
      acc[m] += (TRANS ? w_s[c * (TL + 1) + r] : w_s[r * (TL + 1) + c]) * xv;
    }
  }
}

template <typename T, int HD, int TL>
__device__ __forceinline__ void store_acc(T* dst, int r0_global, int S,
                                          const float (&acc)[kAccRows<HD, TL>],
                                          float mul) {
  constexpr int M = kAccRows<HD, TL>, RS = kThreads / HD;
  const int d = threadIdx.x % HD, r0 = threadIdx.x / HD;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int r = r0_global + r0 + m * RS;
    if (r < S)
      dst[static_cast<long long>(r) * HD + d] = from_float<T>(acc[m] * mul);
  }
}

template <int HD>
constexpr size_t prepass_smem() {
  constexpr int TL = kTile<HD>;
  return sizeof(float) * (2 * TL * (HD + 1) + TL * (TL + 1));
}

template <int HD>
constexpr size_t grad_smem() {
  constexpr int TL = kTile<HD>;
  return sizeof(float) *
         (4 * TL * (HD + 1) + 2 * TL * (TL + 1) + 2 * TL);
}

// (a) lse and D for the rows of one (b, head, query tile).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) bwd_prepass(Args a) {
  constexpr int TL = kTile<HD>, LD = HD + 1, M = kScoreRows<TL>,
                RS = kThreads / TL;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + TL * LD;
  float* s_s = k_s + TL * LD;  // TL x (TL + 1)
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * TL;
  const int H = a.K * a.G, kv = h / a.G, len = key_len(a, b);
  const long long qrow = (static_cast<long long>(b) * H + h) * a.S;
  const long long krow = (static_cast<long long>(b) * a.K + kv) * a.S;
  const T* q = static_cast<const T*>(a.q) + qrow * HD;
  const T* k = static_cast<const T*>(a.k) + krow * HD;
  const T* o = static_cast<const T*>(a.o) + qrow * HD;
  const T* dout = static_cast<const T*>(a.dout) + qrow * HD;
  load_tile<T, HD, TL>(q_s, q, i0, a.S);
  // D: a warp a row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < TL; r += kThreads / 32) {
    const int i = i0 + r;
    float acc = 0.f;
    if (i < a.S)
      for (int d = lane; d < HD; d += 32)
        acc += to_float(o[static_cast<long long>(i) * HD + d]) *
               to_float(dout[static_cast<long long>(i) * HD + d]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0 && i < a.S) a.delta[qrow + i] = acc;
  }
  // lse: thread r < TL keeps row r's running max and sum
  float run_m = -INFINITY, run_l = 0.f;
  const int i_end = min(i0 + TL, a.S);
  const int j_lo = a.window > 0 ? max(0, i0 - a.window + 1) : 0;
  const int j_hi = min(i_end, len);
  const int j = threadIdx.x % TL, ir = threadIdx.x / TL;
  for (int j0 = j_lo / TL * TL; j0 < j_hi; j0 += TL) {
    __syncthreads();
    load_tile<T, HD, TL>(k_s, k, j0, a.S);
    __syncthreads();
    float s[M], unused[M];
    dots<HD, TL, false>(q_s, k_s, nullptr, nullptr, s, unused);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int r = ir + m * RS;
      s_s[r * (TL + 1) + j] =
          attends(a, i0 + r, j0 + j, len) ? s[m] * a.scale : -INFINITY;
    }
    __syncthreads();
    if (threadIdx.x < TL) {
      const float* row = s_s + threadIdx.x * (TL + 1);
      float mx = run_m;
      for (int c = 0; c < TL; ++c) mx = fmaxf(mx, row[c]);
      if (mx > -INFINITY) {
        float l = run_l * expf(run_m - mx);
        for (int c = 0; c < TL; ++c) l += expf(row[c] - mx);
        run_m = mx;
        run_l = l;
      }
    }
  }
  if (threadIdx.x < TL && i0 + static_cast<int>(threadIdx.x) < a.S)
    // an empty row's lse is +inf, so exp(s - lse) is 0 there
    a.lse[qrow + i0 + threadIdx.x] =
        run_l > 0.f ? run_m + logf(run_l) : INFINITY;
}

// P and dS of a (query tile, key tile) into p_s / ds_s (TL x (TL + 1)).
template <int HD, int TL>
__device__ __forceinline__ void probs(const Args& a, const float* q_s,
                                      const float* k_s, const float* do_s,
                                      const float* v_s, const float* lse_s,
                                      const float* dl_s, int i0, int j0,
                                      int len, float* p_s, float* ds_s) {
  constexpr int M = kScoreRows<TL>, RS = kThreads / TL;
  const int j = threadIdx.x % TL, ir = threadIdx.x / TL;
  float s[M], dp[M];
  dots<HD, TL, true>(q_s, k_s, do_s, v_s, s, dp);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int r = ir + m * RS;
    const float p = attends(a, i0 + r, j0 + j, len)
                        ? expf(s[m] * a.scale - lse_s[r])
                        : 0.f;
    if (p_s) p_s[r * (TL + 1) + j] = p;
    ds_s[r * (TL + 1) + j] = p * (dp[m] - dl_s[r]);
  }
}

template <int TL>
__device__ __forceinline__ void load_rows(float* lse_s, float* dl_s,
                                          const Args& a, long long qrow,
                                          int i0) {
  for (int r = threadIdx.x; r < TL; r += kThreads) {
    const bool in = i0 + r < a.S;
    lse_s[r] = in ? a.lse[qrow + i0 + r] : INFINITY;
    dl_s[r] = in ? a.delta[qrow + i0 + r] : 0.f;
  }
}

// (b) dk and dv of one (b, kv head, key tile).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) bwd_dkdv(Args a) {
  constexpr int TL = kTile<HD>, LD = HD + 1, MA = kAccRows<HD, TL>;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + TL * LD;
  float* q_s = v_s + TL * LD;
  float* do_s = q_s + TL * LD;
  float* p_s = do_s + TL * LD;
  float* ds_s = p_s + TL * (TL + 1);
  float* lse_s = ds_s + TL * (TL + 1);
  float* dl_s = lse_s + TL;
  const int b = blockIdx.z, kv = blockIdx.y, j0 = blockIdx.x * TL;
  const int H = a.K * a.G, len = key_len(a, b);
  const long long krow = (static_cast<long long>(b) * a.K + kv) * a.S;
  float acc_k[MA], acc_v[MA];
#pragma unroll
  for (int m = 0; m < MA; ++m) acc_k[m] = acc_v[m] = 0.f;
  if (j0 < len) {
    load_tile<T, HD, TL>(k_s, static_cast<const T*>(a.k) + krow * HD, j0,
                         a.S);
    load_tile<T, HD, TL>(v_s, static_cast<const T*>(a.v) + krow * HD, j0,
                         a.S);
    // query i sees key j iff j <= i < j + window
    const int i_end =
        a.window > 0 ? min(a.S, j0 + TL - 1 + a.window) : a.S;
    for (int g = 0; g < a.G; ++g) {
      const int h = kv * a.G + g;
      const long long qrow = (static_cast<long long>(b) * H + h) * a.S;
      const T* q = static_cast<const T*>(a.q) + qrow * HD;
      const T* dout = static_cast<const T*>(a.dout) + qrow * HD;
      for (int i0 = j0; i0 < i_end; i0 += TL) {
        __syncthreads();
        load_tile<T, HD, TL>(q_s, q, i0, a.S);
        load_tile<T, HD, TL>(do_s, dout, i0, a.S);
        load_rows<TL>(lse_s, dl_s, a, qrow, i0);
        __syncthreads();
        probs<HD, TL>(a, q_s, k_s, do_s, v_s, lse_s, dl_s, i0, j0, len, p_s,
                      ds_s);
        __syncthreads();
        accumulate<HD, TL, true>(p_s, do_s, acc_v);
        accumulate<HD, TL, true>(ds_s, q_s, acc_k);
      }
    }
  }
  store_acc<T, HD, TL>(static_cast<T*>(a.dk) + krow * HD, j0, a.S, acc_k,
                       a.scale);
  store_acc<T, HD, TL>(static_cast<T*>(a.dv) + krow * HD, j0, a.S, acc_v,
                       1.f);
}

// (c) dq of one (b, head, query tile).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) bwd_dq(Args a) {
  constexpr int TL = kTile<HD>, LD = HD + 1, MA = kAccRows<HD, TL>;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + TL * LD;
  float* k_s = do_s + TL * LD;
  float* v_s = k_s + TL * LD;
  float* ds_s = v_s + TL * LD;
  float* lse_s = ds_s + TL * (TL + 1);
  float* dl_s = lse_s + TL;
  const int b = blockIdx.z, h = blockIdx.y;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * TL;  // longest tiles first
  const int H = a.K * a.G, kv = h / a.G, len = key_len(a, b);
  const long long qrow = (static_cast<long long>(b) * H + h) * a.S;
  const long long krow = (static_cast<long long>(b) * a.K + kv) * a.S;
  const T* k = static_cast<const T*>(a.k) + krow * HD;
  const T* v = static_cast<const T*>(a.v) + krow * HD;
  load_tile<T, HD, TL>(q_s, static_cast<const T*>(a.q) + qrow * HD, i0, a.S);
  load_tile<T, HD, TL>(do_s, static_cast<const T*>(a.dout) + qrow * HD, i0,
                       a.S);
  load_rows<TL>(lse_s, dl_s, a, qrow, i0);
  float acc[MA];
#pragma unroll
  for (int m = 0; m < MA; ++m) acc[m] = 0.f;
  const int j_lo = a.window > 0 ? max(0, i0 - a.window + 1) : 0;
  const int j_hi = min(min(i0 + TL, a.S), len);
  for (int j0 = j_lo / TL * TL; j0 < j_hi; j0 += TL) {
    __syncthreads();
    load_tile<T, HD, TL>(k_s, k, j0, a.S);
    load_tile<T, HD, TL>(v_s, v, j0, a.S);
    __syncthreads();
    probs<HD, TL>(a, q_s, k_s, do_s, v_s, lse_s, dl_s, i0, j0, len, nullptr,
                  ds_s);
    __syncthreads();
    accumulate<HD, TL, false>(ds_s, k_s, acc);
  }
  store_acc<T, HD, TL>(static_cast<T*>(a.dq) + qrow * HD, i0, a.S, acc,
                       a.scale);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int TL = kTile<HD>;
  constexpr size_t pre = prepass_smem<HD>(), grad = grad_smem<HD>();
  cudaError_t err = allow_smem(bwd_prepass<T, HD>, pre);
  if (err == cudaSuccess) err = allow_smem(bwd_dkdv<T, HD>, grad);
  if (err == cudaSuccess) err = allow_smem(bwd_dq<T, HD>, grad);
  if (err != cudaSuccess) return err;
  const int tiles = (a.S + TL - 1) / TL, H = a.K * a.G;
  bwd_prepass<T, HD><<<dim3(tiles, H, a.B), kThreads, pre, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dkdv<T, HD><<<dim3(tiles, a.K, a.B), kThreads, grad, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dq<T, HD><<<dim3(tiles, H, a.B), kThreads, grad, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_head_dim(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v, o, dout, dq, dk and dv alike).
// lengths may be null; window <= 0 means no window; lse and delta are
// float [B, H, S] scratch.  Returns the cudaError_t of the launches
// (0 = success).
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lengths,
                                   void* lse, void* delta, void* dq, void* dk,
                                   void* dv, int B, int K, int G, int hd,
                                   int S, int window, void* stream) {
  const Args a{q, k, v, o, dout, static_cast<const int32_t*>(lengths),
               static_cast<float*>(lse), static_cast<float*>(delta), dq, dk,
               dv, B, K, G, S, window, 1.f / sqrtf(static_cast<float>(hd))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return by_head_dim<float>(hd, a, st);
    case 1: return by_head_dim<__nv_bfloat16>(hd, a, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
