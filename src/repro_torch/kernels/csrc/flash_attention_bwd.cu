// Flash-attention backward for Hopper (sm_90a): the gradients dq, dk, dv of
// flash_attention.cu's causal grouped-query attention, with its optional
// sliding window, per-sequence lengths and bidirectional prefix (query i
// attends key j iff j <= i or both are below the prefix P).
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
//   lse         [B, H, S] f32   bf16: the forward's (flash_tc.cuh, natural
//                               log, +inf for an empty row), read; fp32:
//                               scratch the pre-pass writes
//   delta       [B, H, S] f32   scratch: D = rowsum(dout * o)
//   part        [NS, 2, B, K, S, HD] f32   bf16 with NS > 1: each head
//                               group's dk, dv; else null
//   dq          [B, H, S, HD]   type of q
//   dk, dv      [B, K, S, HD]   type of q
//
// With s = q.k / sqrt(HD) over the valid (query, key) pairs, P = softmax(s)
// = exp(s - lse) and o = P v:  D = rowsum(dout * o), dP = dout v^T,
// dS = P * (dP - D), dq = dS k / sqrt(HD), dk = dS^T q / sqrt(HD) and
// dv = P^T dout, dk and dv summed over the G query heads of a kv head.  A
// query row with no valid key (lengths 0) gets zero gradients, as the
// forward gives it zeros.
//
// What bounds it on the H100: operations.  Each valid (query, key) pair
// needs five products of HD multiply-adds (s, dP, dq, dk, dv: 10 * HD
// FLOP) against 2 * 3 * S * HD elements read per head, far above the
// ~295 FLOP/byte ridge of bf16 once S reaches a few hundred; this design
// does seven (s and dP once for dk/dv and once more for dq, so that
// neither needs atomics).
//
// bf16 (dtype 1) runs on the tensor cores with flash_tc.cuh's pieces (the
// core-matrix tiles and their cp.async ring, the descriptors, score_tile
// and pv_tile), in fp32 registers, in three or four launches and no
// atomics, so two calls give the same bits:
//   (a) D, a 16-byte load of o and dout a thread (bytes-bound); lse is the
//       forward's, so no score is recomputed for it;
//   (b) dk/dv, a block per (b, kv head, tile of 64 keys, head group): the
//       tile's K and V are staged once and the Q and dO tiles of BM queries
//       (with their rows' lse and D) of the group's heads stream through
//       the two-stage ring, from the diagonal (from query 0 for a key tile
//       that starts below P) to the window's end.  The
//       keys are wgmma's M rows, so nothing is transposed in registers:
//         S^T = K Q^T        (ss)
//         P^T = 2^(S^T scale log2e - lse log2e), masked only on tiles
//               that straddle the diagonal (or the prefix's edge), the
//               window's edge, the length or S
//         dV += P^T dO       (rs: P^T packed to bf16 in registers, dO read
//                             MN-major from the same tile bytes)
//         dP^T = V dO^T      (ss)
//         dS^T = P^T (dP^T - D)
//         dK += dS^T Q       (rs, Q MN-major)
//       dk and dv of 64 keys x HD take HD fp32 registers a thread, so from
//       HD 128 on two warpgroups own half the columns each, and each
//       computes S^T and dP^T over the full HD (two of the step's four
//       products done twice: adding half-HD partials through shared
//       memory instead was 5% slower at HD 256 for its four barriers a
//       step, PERF.md).  dV's product is issued together with dP^T's, one
//       wait for both.  The G query heads are split into NS groups
//       (cuda_lib.bwd_splits, so that one kv head fills the card): each
//       group writes fp32 partials and (d) adds them in a fixed order and
//       rounds them to bf16; with NS = 1 (b) writes bf16 itself;
//   (c) dq, a block per (b, head, 128 queries) as the forward, Q and dO
//       staged once and K/V tiles (64 keys, 32 at HD 256) through the
//       ring: S = Q K^T and dP = dO V^T (score_tile, one wgmma group), P
//       from lse, dS = P (dP - D), dQ += dS K (rs, K read MN-major), dQ in
//       fp32 registers as the forward's o.
//
// fp32 (dtype 0) keeps the first version (there is no full-precision
// tensor-core path): fp32 FMA on the CUDA cores and three kernels, no
// atomics:
//   (a) pre-pass, a block per (b, head, query tile): recomputes each row's
//       lse over its valid keys (online max and sum) and D = rowsum(do*o);
//   (b) dk/dv, a block per (b, kv head, key tile): walks the query tiles
//       of all G heads from the tile's diagonal (from 0 for a key tile
//       that starts below P) to its window's end, accumulating dk and dv
//       in registers;
//   (c) dq, a block per (b, head, query tile): walks the key tiles from
//       the window's start to the diagonal (to P - 1 at least, for a
//       tile that starts below P; capped at the length), accumulating dq
//       in registers, longest tiles first.
// Tiles of TL rows (64 at HD <= 64, 32 at 128, 16 at 256) are staged in
// shared memory as fp32 with a row stride of HD + 1, so a warp reading one
// column of K across 32 rows hits 32 banks.  A thread of a score tile owns
// one key column and TL * TL / 256 query rows; a thread of an accumulator
// owns one head-dim column and TL * HD / 256 rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_tc.cuh"

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
  int B, K, G, S, window, prefix;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// Keys t < len are attendable.
__device__ __forceinline__ int key_len(const Args& a, int b) {
  return a.lengths ? min(max(a.lengths[b], 0), a.S) : a.S;
}

__device__ __forceinline__ bool attends(const Args& a, int i, int j,
                                        int len) {
  return i < a.S && (j <= i || (i < a.prefix && j < a.prefix)) && j < len &&
         (a.window <= 0 || j > i - a.window);
}

// One past the last key a query tile starting at i0 and ending before
// i_end can attend: its diagonal, or the prefix's end for a tile that
// starts in the prefix.
__device__ __forceinline__ int key_end(const Args& a, int i0, int i_end) {
  return max(i_end, i0 < a.prefix ? a.prefix : 0);
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
  const int j_hi = min(key_end(a, i0, i_end), len);
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
    // query i sees key j iff j <= i < j + window, or both are in the
    // prefix
    const int i_start = j0 < a.prefix ? 0 : j0;
    const int i_end =
        a.window > 0 ? min(a.S, j0 + TL - 1 + a.window) : a.S;
    for (int g = 0; g < a.G; ++g) {
      const int h = kv * a.G + g;
      const long long qrow = (static_cast<long long>(b) * H + h) * a.S;
      const T* q = static_cast<const T*>(a.q) + qrow * HD;
      const T* dout = static_cast<const T*>(a.dout) + qrow * HD;
      for (int i0 = i_start; i0 < i_end; i0 += TL) {
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
  const int j_hi = min(key_end(a, i0, min(i0 + TL, a.S)), len);
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

// ------------------------------------------------ bf16: the tensor cores

// Internal linkage, like the fp32 path: the static in launch() must stay
// this library's when another build of it is loaded beside it
// (scripts/flash_bwd_variants.py).
namespace {
namespace tcb {

namespace tc = flash_tc;

constexpr float kLog2e = 1.4426950408889634f;
// keys of a dk/dv block: wgmma's M (cuda_lib.TC_ROWS, which bwd_splits
// counts the blocks by)
constexpr int kKeys = tc::kRows;
constexpr int kQueries = 64;     // queries of a dk/dv step (N of S^T)
constexpr int kQueries256 = 64;  // ... at HD 256
constexpr int kDqGroups = 2;     // query warpgroups of a dq block
constexpr int kDqKeys256 = 32;   // keys of a dq step at HD 256 (else 64)
// (scripts/flash_bwd_variants.py times the other values of these)

struct Args {
  const __nv_bfloat16* q;     // [B, H, S, HD]
  const __nv_bfloat16* k;     // [B, K, S, HD]
  const __nv_bfloat16* v;     // [B, K, S, HD]
  const __nv_bfloat16* o;     // [B, H, S, HD]
  const __nv_bfloat16* dout;  // [B, H, S, HD]
  const int32_t* lengths;     // [B] or null
  const float* lse;           // [B, H, S] the forward's, natural log
  float* delta;               // [B, H, S] D, written by (a)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* part;                // [NS, 2, B, K, S, HD] with NS > 1, else null
  int B, K, G, S, window, prefix, splits;
  float scale;
};

template <int HD>
__host__ __device__ constexpr int dkdv_queries() {
  return HD == 256 ? kQueries256 : kQueries;
}
// dk and dv columns split across two warpgroups from HD 128 on
template <int HD>
__host__ __device__ constexpr int dkdv_groups() {
  return HD >= 128 ? 2 : 1;
}
template <int HD>
__host__ __device__ constexpr int dq_keys() {
  return HD == 256 ? kDqKeys256 : 64;
}

// Dynamic shared memory of a dk/dv block: K and V [64, HD], kStages stages
// of Q and dO [BM, HD] (bf16) and of their rows' lse and D (fp32).
template <int HD>
constexpr size_t dkdv_smem() {
  constexpr int BM = dkdv_queries<HD>();
  return 2 * HD * (2 * kKeys + 2 * tc::kStages * BM) +
         4 * 2 * tc::kStages * BM;
}

// ... of a dq block: Q and dO [128, HD], kStages stages of K and V.
template <int HD>
constexpr size_t dq_smem() {
  return 2 * HD *
         (2 * tc::kRows * kDqGroups + 2 * tc::kStages * dq_keys<HD>());
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void fence_async() {
  // cp.async writes are generic-proxy; wgmma reads through the async one
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// (a) D = rowsum(dout * o): HD / 8 threads a row, 16 bytes of each a
// thread, added with shuffles.
template <int HD>
__global__ void __launch_bounds__(256) delta_kernel(const Args a) {
  constexpr int TPR = HD / 8;
  const long long rows = static_cast<long long>(a.B) * a.K * a.G * a.S;
  const long long row =
      static_cast<long long>(blockIdx.x) * (256 / TPR) + threadIdx.x / TPR;
  const int c = threadIdx.x % TPR;
  float acc = 0.f;
  if (row < rows) {
    const uint4 x = *reinterpret_cast<const uint4*>(a.o + row * HD + 8 * c);
    const uint4 y =
        *reinterpret_cast<const uint4*>(a.dout + row * HD + 8 * c);
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fx = __bfloat1622float2(xp[i]);
      const float2 fy = __bfloat1622float2(yp[i]);
      acc = fmaf(fx.x, fy.x, acc);
      acc = fmaf(fx.y, fy.y, acc);
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && c == 0) a.delta[row] = acc;
}

// Packs a [64, BM] accumulator tile into wgmma's register A fragments
// (as flash_tc::softmax_tile packs P).
template <int BM>
__device__ __forceinline__ void pack_tile(const float* s, uint32_t (*p)[4]) {
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
    p[j / 2][2 * (j % 2)] = tc::pack_bf16(s[4 * j], s[4 * j + 1]);
    p[j / 2][2 * (j % 2) + 1] = tc::pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

// (b) dk and dv of one (b, kv head, key tile, head group).
template <int HD>
__global__ void __launch_bounds__(tc::kWG * dkdv_groups<HD>())
    dkdv_kernel(const Args a) {
  constexpr int WG = dkdv_groups<HD>(), BM = dkdv_queries<HD>();
  constexpr int THREADS = tc::kWG * WG, CW = HD / WG;  // columns a wg
  constexpr uint32_t CM = 128, ROW8 = HD / 8 * CM;
  constexpr uint32_t KV_BYTES = kKeys / 8 * ROW8, QT_BYTES = BM / 8 * ROW8;
  extern __shared__ __align__(128) uint8_t bwd_smem[];
  const uint32_t k_s = tc::smem_addr(bwd_smem), v_s = k_s + KV_BYTES;
  float* rows_s = reinterpret_cast<float*>(bwd_smem + 2 * KV_BYTES +
                                           tc::kStages * 2 * QT_BYTES);

  const int wg = threadIdx.x / tc::kWG, warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int ns = a.splits, grp = blockIdx.x % ns, bk = blockIdx.x / ns;
  const int b = bk / a.K, kv = bk % a.K, H = a.K * a.G;
  const int j0 = blockIdx.y * kKeys;  // longest tiles (low j0) first
  const int len = a.lengths ? min(max(a.lengths[b], 0), a.S) : a.S;
  const int g0 = a.G * grp / ns, g1 = a.G * (grp + 1) / ns;
  // query i sees key j iff j <= i < j + window, or both are in the
  // prefix (so a key tile that starts there takes queries from 0); a tile
  // past the length has no query
  const int i_start = j0 < a.prefix ? 0 : j0;
  const int i_end = j0 >= len ? i_start
                    : a.window > 0 ? min(a.S, j0 + kKeys - 1 + a.window)
                                   : a.S;
  const int nt = (i_end - i_start + BM - 1) / BM;  // query tiles a head
  const int steps = (g1 - g0) * nt;
  const size_t kv_off = (static_cast<size_t>(b) * a.K + kv) * a.S * HD;

  auto stage = [&](int t) {
    return v_s + KV_BYTES + t % tc::kStages * 2 * QT_BYTES;
  };
  auto rows_of = [&](int t) { return rows_s + t % tc::kStages * 2 * BM; };
  // step t's Q and dO tiles and their rows' lse and D as one cp.async
  // group (empty past the last step); rows past S are zeros
  auto load_q = [&](int t) {
    if (t < steps) {
      const int h = kv * a.G + g0 + t / nt, i0 = i_start + t % nt * BM;
      const size_t qrow = (static_cast<size_t>(b) * H + h) * a.S;
      tc::load_tile<HD, BM, THREADS>(stage(t), a.q + qrow * HD, i0, a.S);
      tc::load_tile<HD, BM, THREADS>(stage(t) + QT_BYTES,
                                     a.dout + qrow * HD, i0, a.S);
      float* r = rows_of(t);
      for (int x = threadIdx.x; x < 2 * BM; x += THREADS) {
        const int i = i0 + x % BM;
        const bool ok = i < a.S;
        cp_async4(tc::smem_addr(r + x),
                  (x < BM ? a.lse : a.delta) + qrow + (ok ? i : 0), ok);
      }
    }
    tc::cp_async_commit();
  };

  if (steps > 0) {
    tc::load_tile<HD, kKeys, THREADS>(k_s, a.k + kv_off, j0, len);
    tc::load_tile<HD, kKeys, THREADS>(v_s, a.v + kv_off, j0, len);
  }
#pragma unroll
  for (int i = 0; i < tc::kAhead; ++i) load_q(i);  // K and V join the first

  const float scale_log2 = kLog2e * a.scale;
  // this thread's key rows r0, r0 + 8 of the tile, and query columns c0,
  // c0 + 1 of every 8 of a step
  const int r0 = warp * 16 + lane / 4, c0 = 2 * (lane % 4);
  const uint32_t col = wg * (CW / 8) * CM;  // the wg's columns of Q / dO
  float dk[CW / 2], dv[CW / 2], st[BM / 2], dpt[BM / 2];
#pragma unroll
  for (int i = 0; i < CW / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) st[i] = dpt[i] = 0.f;

  for (int t = 0; t < steps; ++t) {
    tc::cp_async_wait<tc::kAhead - 1>();
    fence_async();
    // step t is in place, and every warpgroup is done with step t - 1,
    // whose stage the load of step t + kAhead overwrites
    __syncthreads();
    load_q(t + tc::kAhead);
    const int i0 = i_start + t % nt * BM;
    const uint32_t q_s = stage(t), do_s = q_s + QT_BYTES;
    const float* lse_s = rows_of(t);
    const float* d_s = lse_s + BM;

    tc::score_tile<HD, BM>(st, k_s, q_s);  // S^T = K Q^T, each wg in full
    // st[4 j + 2 i + e] is key j0 + r0 + 8 i, query i0 + 8 j + c0 + e
    if (!((i0 >= j0 + kKeys - 1 ||
           (i0 + BM <= a.prefix && j0 + kKeys <= a.prefix)) &&
          j0 + kKeys <= len && i0 + BM <= a.S &&
          (a.window <= 0 || j0 > i0 + BM - 1 - a.window))) {
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + r0 + 8 * (e >> 1);
          const int qi = i0 + 8 * j + c0 + (e & 1);
          if (!(qi < a.S &&
                (key <= qi || (qi < a.prefix && key < a.prefix)) &&
                key < len && (a.window <= 0 || key > qi - a.window)))
            st[4 * j + e] = -INFINITY;
        }
    }
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[4 * j + e] = tc::ex2(fmaf(st[4 * j + e], scale_log2,
                                     -(e & 1 ? l.y : l.x) * kLog2e));
    }
    uint32_t frag[BM / 16][4];
    pack_tile<BM>(st, frag);
    // dV += P^T dO, only issued, and completed by the wait for dP^T =
    // V dO^T
    tc::pv_tile<HD, BM, CW, false>(dv, frag, do_s + col);
    tc::score_tile<HD, BM>(dpt, v_s, do_s);
    tc::fence_regs<CW / 2>(dv);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(d_s + 8 * j + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * j + e] =
            st[4 * j + e] * (dpt[4 * j + e] - (e & 1 ? d.y : d.x));
    }
    pack_tile<BM>(dpt, frag);
    tc::pv_tile<HD, BM, CW>(dk, frag, q_s + col);  // dK += dS^T Q
  }
  tc::cp_async_wait<0>();

  // dk[4 jj + 2 i + e] is key j0 + r0 + 8 i, column wg * CW + 8 jj + c0 + e
  const size_t n = static_cast<size_t>(a.B) * a.K * a.S * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = j0 + r0 + 8 * i;
    if (key >= a.S) continue;
    const size_t at = kv_off + static_cast<size_t>(key) * HD + wg * CW + c0;
    if (ns == 1) {
      uint32_t* gk = reinterpret_cast<uint32_t*>(a.dk + at);
      uint32_t* gv = reinterpret_cast<uint32_t*>(a.dv + at);
#pragma unroll
      for (int jj = 0; jj < CW / 8; ++jj) {
        gk[4 * jj] = tc::pack_bf16(dk[4 * jj + 2 * i] * a.scale,
                                   dk[4 * jj + 2 * i + 1] * a.scale);
        gv[4 * jj] = tc::pack_bf16(dv[4 * jj + 2 * i], dv[4 * jj + 2 * i + 1]);
      }
    } else {
      float2* pk = reinterpret_cast<float2*>(a.part + 2 * grp * n + at);
      float2* pv = reinterpret_cast<float2*>(a.part + (2 * grp + 1) * n + at);
#pragma unroll
      for (int jj = 0; jj < CW / 8; ++jj) {
        pk[4 * jj] = make_float2(dk[4 * jj + 2 * i], dk[4 * jj + 2 * i + 1]);
        pv[4 * jj] = make_float2(dv[4 * jj + 2 * i], dv[4 * jj + 2 * i + 1]);
      }
    }
  }
}

// (d) dk = scale * sum of the NS groups' partials and dv = their sum, in
// group order, rounded to bf16: 4 elements a thread.
__global__ void __launch_bounds__(256) sum_kernel(const Args a, size_t n) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i >= 2 * n) return;
  const int which = i >= n;  // 0: dk, 1: dv
  const size_t e = i - which * n;
  float4 acc = *reinterpret_cast<const float4*>(a.part + which * n + e);
  for (int g = 1; g < a.splits; ++g) {
    const float4 x =
        *reinterpret_cast<const float4*>(a.part + (2 * g + which) * n + e);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const float mul = which ? 1.f : a.scale;
  uint2 out;
  out.x = tc::pack_bf16(acc.x * mul, acc.y * mul);
  out.y = tc::pack_bf16(acc.z * mul, acc.w * mul);
  *reinterpret_cast<uint2*>((which ? a.dv : a.dk) + e) = out;
}

// (c) dq of one (b, head, 128 queries): the forward's walk.
template <int HD>
__global__ void __launch_bounds__(tc::kWG * kDqGroups)
    dq_kernel(const Args a) {
  constexpr int WG = kDqGroups, BN = dq_keys<HD>(), THREADS = tc::kWG * WG;
  constexpr int QR = tc::kRows * WG;  // query rows of a block
  constexpr uint32_t CM = 128, ROW8 = HD / 8 * CM;
  constexpr uint32_t Q_BYTES = tc::kRows / 8 * ROW8, KV_BYTES = BN / 8 * ROW8;
  extern __shared__ __align__(128) uint8_t bwd_smem[];
  const uint32_t q_s = tc::smem_addr(bwd_smem), do_s = q_s + WG * Q_BYTES;

  const int wg = threadIdx.x / tc::kWG, warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int hq = blockIdx.x, b = blockIdx.y, H = a.K * a.G, kv = hq / a.G;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * QR;  // longest first
  const int len = a.lengths ? min(max(a.lengths[b], 0), a.S) : a.S;
  // Keys any row of the block can attend: [t_lo, t_hi], in tiles n0..n1;
  // rows in the prefix reach its last key as well as their diagonal.
  const int t_hi =
      min(max(q0 + QR - 1, q0 < a.prefix ? a.prefix - 1 : 0), len - 1);
  const int t_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int n0 = t_lo / BN, n1 = t_hi >= t_lo ? t_hi / BN : n0 - 1;
  // ... and the keys of this warpgroup's 64 rows
  const int qw = q0 + tc::kRows * wg;
  const int w_hi = min(
      max(qw + tc::kRows - 1, qw < a.prefix ? a.prefix - 1 : 0), len - 1);
  const int w_lo = a.window > 0 ? max(0, qw - a.window + 1) : 0;

  const size_t qrow = (static_cast<size_t>(b) * H + hq) * a.S;
  const size_t kv_off = (static_cast<size_t>(b) * a.K + kv) * a.S * HD;
  auto k_stage = [&](int n) {
    return do_s + WG * Q_BYTES + (n - n0) % tc::kStages * 2 * KV_BYTES;
  };
  auto load_kv = [&](int n) {
    if (n <= n1) {
      tc::load_tile<HD, BN, THREADS>(k_stage(n), a.k + kv_off, n * BN, len);
      tc::load_tile<HD, BN, THREADS>(k_stage(n) + KV_BYTES, a.v + kv_off,
                                     n * BN, len);
    }
    tc::cp_async_commit();
  };

  tc::load_tile<HD, QR, THREADS>(q_s, a.q + qrow * HD, q0, a.S);
  tc::load_tile<HD, QR, THREADS>(do_s, a.dout + qrow * HD, q0, a.S);
#pragma unroll
  for (int i = 0; i < tc::kAhead; ++i) load_kv(n0 + i);  // Q, dO join

  const float scale_log2 = kLog2e * a.scale;
  const int r0 = qw + warp * 16 + lane / 4;  // this thread's rows: r0, r0 + 8
  const int c0 = 2 * (lane % 4);             // and columns c0, c0 + 1 of 8
  float lse2[2], dl[2];  // the rows' lse (log2 units) and D
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    lse2[i] = row < a.S ? a.lse[qrow + row] * kLog2e : INFINITY;
    dl[i] = row < a.S ? a.delta[qrow + row] : 0.f;
  }
  float dq[HD / 2], s[BN / 2], dp[BN / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;

  for (int n = n0; n <= n1; ++n) {
    tc::cp_async_wait<tc::kAhead - 1>();
    fence_async();
    __syncthreads();
    load_kv(n + tc::kAhead);
    const int k0 = n * BN;
    // a warpgroup skips the tiles none of its rows can attend
    if (qw >= a.S || k0 > w_hi || k0 + BN - 1 < w_lo) continue;
    const uint32_t k_s = k_stage(n), v_s = k_s + KV_BYTES;

    // S = Q K^T and dP = dO V^T as one wgmma group
    tc::score_tile<HD, BN, false>(s, q_s + wg * Q_BYTES, k_s);
    tc::score_tile<HD, BN, false>(dp, do_s + wg * Q_BYTES, v_s);
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::fence_regs<BN / 2>(s);
    tc::fence_regs<BN / 2>(dp);
    // s[4 j + 2 i + e] is row r0 + 8 i, key k0 + 8 j + c0 + e
    if (!((k0 + BN - 1 <= qw ||
           (qw + tc::kRows <= a.prefix && k0 + BN <= a.prefix)) &&
          k0 + BN <= len &&
          (a.window <= 0 || k0 > qw + tc::kRows - 1 - a.window))) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + 8 * (e >> 1);
          const int key = k0 + 8 * j + c0 + (e & 1);
          if (!((key <= row || (row < a.prefix && key < a.prefix)) &&
                key < len && (a.window <= 0 || key > row - a.window)))
            s[4 * j + e] = -INFINITY;
        }
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            tc::ex2(fmaf(s[4 * j + e], scale_log2, -lse2[e >> 1]));
        s[4 * j + e] = p * (dp[4 * j + e] - dl[e >> 1]);  // dS
      }
    uint32_t frag[BN / 16][4];
    pack_tile<BN>(s, frag);
    tc::pv_tile<HD, BN>(dq, frag, k_s);  // dQ += dS K
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= a.S) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        a.dq + (qrow + row) * HD + c0);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      dst[4 * j] = tc::pack_bf16(dq[4 * j + 2 * i] * a.scale,
                                 dq[4 * j + 2 * i + 1] * a.scale);
  }
}

template <int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t kv_smem = dkdv_smem<HD>(), q_smem = dq_smem<HD>();
  static_assert(kv_smem <= 232448 && q_smem <= 232448, "shared memory");
  // the shared-memory attributes once a device (devices 0-31): a training
  // step calls this once a layer, and the host's time is its bottleneck
  static std::atomic<unsigned> ready{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned bit = device < 32 ? 1u << device : 0u;
  if (!(ready.load() & bit)) {
    err = allow_smem(dkdv_kernel<HD>, kv_smem);
    if (err == cudaSuccess) err = allow_smem(dq_kernel<HD>, q_smem);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit);
  }
  const int H = a.K * a.G, per_block = 256 / (HD / 8);
  const long long rows = static_cast<long long>(a.B) * H * a.S;
  delta_kernel<HD><<<static_cast<unsigned>((rows + per_block - 1) /
                                           per_block),
                     256, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv_kernel<HD><<<dim3(a.B * a.K * a.splits, (a.S + kKeys - 1) / kKeys),
                    tc::kWG * dkdv_groups<HD>(), kv_smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr int QR = tc::kRows * kDqGroups;
  dq_kernel<HD><<<dim3(H, a.B, (a.S + QR - 1) / QR), tc::kWG * kDqGroups,
                  q_smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (a.splits > 1) {
    const size_t n = static_cast<size_t>(a.B) * a.K * a.S * HD;
    sum_kernel<<<static_cast<unsigned>((2 * n / 4 + 255) / 256), 256, 0,
                 stream>>>(a, n);
  }
  return cudaGetLastError();
}

cudaError_t by_head_dim(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32>(a, stream);
    case 64: return launch<64>(a, stream);
    case 128: return launch<128>(a, stream);
    case 256: return launch<256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tcb
}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v, o, dout, dq, dk and dv alike).
// lengths may be null; window <= 0 means no window; prefix 0 means none
// (0 <= prefix <= S); delta is float [B, H, S] scratch; lse is float [B,
// H, S]: the forward's with dtype 1, scratch with dtype 0.  splits is NS, the head groups of the bf16 dk/dv kernel
// (1 to G; 1 with dtype 0), and part its float [NS, 2, B, K, S, HD]
// scratch when NS > 1, else null.  Returns the cudaError_t of the
// launches (0 = success).
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lengths,
                                   void* lse, void* delta, void* dq, void* dk,
                                   void* dv, void* part, int B, int K, int G,
                                   int hd, int S, int window, int prefix,
                                   int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  if (splits < 1 || splits > G || (splits > 1) != (part != nullptr) ||
      prefix < 0 || prefix > S)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: {
      if (splits != 1) return cudaErrorInvalidValue;
      const Args a{q, k, v, o, dout, static_cast<const int32_t*>(lengths),
                   static_cast<float*>(lse), static_cast<float*>(delta), dq,
                   dk, dv, B, K, G, S, window, prefix, scale};
      return by_head_dim<float>(hd, a, st);
    }
    case 1: {
      using bf = __nv_bfloat16;
      const tcb::Args a{static_cast<const bf*>(q), static_cast<const bf*>(k),
                        static_cast<const bf*>(v), static_cast<const bf*>(o),
                        static_cast<const bf*>(dout),
                        static_cast<const int32_t*>(lengths),
                        static_cast<const float*>(lse),
                        static_cast<float*>(delta), static_cast<bf*>(dq),
                        static_cast<bf*>(dk), static_cast<bf*>(dv),
                        static_cast<float*>(part), B, K, G, S, window, prefix,
                        splits, scale};
      return tcb::by_head_dim(hd, a, st);
    }
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
