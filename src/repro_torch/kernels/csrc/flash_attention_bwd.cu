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
//   lse         [B, H, S] f32   the forward's (flash_tc.cuh, flash_tf32.cuh:
//                               natural log, +inf for an empty row), read
//   delta       [B, H, S] f32   scratch: D = rowsum(dout * o)
//   part        [NS, 2, B, K, S, HD] f32   with NS > 1: each head group's
//                               dk, dv; else null
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
// fp32 (dtype 0) runs the same four steps on the tensor cores as 3xTF32
// products (flash_tf32.cuh: each fp32 input split into tf32 hi and lo in
// registers, lo hi + hi lo + hi hi into fp32 accumulators, about 2^-21 of
// each product lost), P from the forward's lse as in bf16, no atomics;
// each step's dV, dK and dQ products are summed from zero and added into
// the running sums by fp32 adds (accum3_step; dV and dK on the tensor
// cores at HD 256, whose head groups cuda_lib.bwd_splits keeps to two
// heads), since the tensor cores' own adds round toward zero and drift
// over a long walk:
//   (a) D, two 16-byte loads of o and dout a thread;
//   (b) dk/dv, a block per (b, kv head, key tile, head group), the key
//       tile's K and V split into hi / lo once, each step's Q and dO tiles
//       (BM queries) split on their way into a two-stage ring (one stage
//       at HD 256) as they lie and transposed, since tf32 wgmma takes
//       operands K-major only:
//         S^T = K Q^T, dP^T = V dO^T   (A and B as they lie)
//         dV += P^T dO, dK += dS^T Q   (P^T, dS^T from registers; B the
//                                       transposed dO and Q, their rows
//                                       permuted so that the accumulator
//                                       registers are the A fragments)
//       Shared memory sets the tiles: K and V hi / lo are 16 bytes a key
//       and column, and a step's four copies of Q and dO 32, so BM is 64
//       queries at HD 32, 32 at HD 64, 8 at HD 128 and 256, and at HD 256
//       the block holds 32 keys, the upper 32 rows of wgmma's 64 computed
//       and never stored.  Up to HD 64 the block's two warpgroups walk
//       alternate query steps, each through its own stage, and add their
//       dk and dv in a fixed order at the end (one warpgroup a block walking
//       every step was 1.3x slower at whisper's encoder on an H100:
//       scripts/flash_f32_variants.py); from HD 128 two warpgroups own
//       half the columns of dk and dv each, as in bf16, but the first
//       computes S^T and P^T and the second dP^T, and they swap them
//       through shared memory, so no score product is done twice;
//   (c) dq, a block per (b, head, 64 queries a warpgroup; 32 at HD 256,
//       as (b)), Q and dO split once, K and V tiles (BN keys: 64 at HD 32,
//       32 at 64, 16 at 128, 8 at 256) split as they lie and K also
//       transposed: S = Q K^T, dP = dO V^T, dS = P (dP - D), dQ += dS K;
//       at HD 256 two warpgroups share the 32 queries, the first computing
//       S and the second dP, swapped as in (b), and own half of dq's
//       columns each;
//   (d) with NS > 1 the groups' fp32 partials added in group order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_tc.cuh"
#include "flash_tf32.cuh"

namespace {

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// ------------------------------------------------ bf16: the tensor cores

// Internal linkage: the static in launch() must stay
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

// ------------------------------------------------ fp32: 3xTF32 on wgmma

namespace {
namespace tfb {

namespace tc = flash_tc;
namespace tf = flash_tf32;
using tf::kLog2e;

struct Args {
  const float* q;      // [B, H, S, HD]
  const float* k;      // [B, K, S, HD]
  const float* v;      // [B, K, S, HD]
  const float* o;      // [B, H, S, HD]
  const float* dout;   // [B, H, S, HD]
  const int32_t* lengths;  // [B] or null
  const float* lse;    // [B, H, S] the forward's, natural log
  float* delta;        // [B, H, S] D, written by (a)
  float* dq;
  float* dk;
  float* dv;
  float* part;         // [NS, 2, B, K, S, HD] with NS > 1, else null
  int B, K, G, S, window, prefix, splits;
  float scale;
};

// Streams of query steps in a dk/dv block up to HD 64, and keys and stages
// of a dq tile at HD 64 (scripts/flash_f32_variants.py times other values)
constexpr int kKvStreams = 2;
constexpr int kDqGroups64 = 2;
constexpr int kDqKeys64 = 32;
constexpr int kDqStages64 = 2;

// (b)'s block: CG warpgroups splitting dk / dv's columns times SG streams
// of query steps (stream s takes steps s, s + SG, ...; its own dk / dv,
// added in stream order at the end), MK keys (the first MK of wgmma's 64
// rows), BM queries a step, NSTAGE stages in all (NSTAGE / SG a stream).
template <int HD>
__host__ __device__ constexpr int kv_groups() { return HD >= 128 ? 2 : 1; }
template <int HD>
__host__ __device__ constexpr int kv_streams() {
  return HD <= 64 ? kKvStreams : 1;
}
template <int HD>
__host__ __device__ constexpr int kv_keys() { return HD == 256 ? 32 : 64; }
template <int HD>
__host__ __device__ constexpr int kv_queries() {
  return HD == 32 ? 64 : HD == 64 ? 32 : 8;
}
template <int HD>
__host__ __device__ constexpr int kv_stages() { return HD == 256 ? 1 : 2; }
template <int HD>
__host__ __device__ constexpr int kv_threads() {
  return tc::kWG * kv_groups<HD>() * kv_streams<HD>();
}
// A stage: Q, Q^T, dO and dO^T hi / lo, then lse and D (whole 1024-byte
// atoms, for the swizzled tiles)
template <int HD>
__host__ __device__ constexpr uint32_t kv_stage_bytes() {
  return 32 * kv_queries<HD>() * HD +
         (8 * kv_queries<HD>() + 1023) / 1024 * 1024;
}
// K and V hi / lo, the stages, and with two column warpgroups a tile of
// P^T and one of dP^T (BM / 2 values a thread)
template <int HD>
constexpr size_t dkdv_smem() {
  return 16ull * kv_keys<HD>() * HD + kv_stages<HD>() * kv_stage_bytes<HD>() +
         (kv_groups<HD>() > 1 ? 4ull * tc::kWG * kv_queries<HD>() : 0);
}

// (c)'s block: WG warpgroups of MQ queries (the first MQ of wgmma's 64
// rows) times CG warpgroups splitting dq's columns, key tiles of BN
// through NSTAGE stages.
template <int HD>
__host__ __device__ constexpr int dq_groups() {
  return HD == 32 ? 2 : HD == 64 ? kDqGroups64 : 1;
}
template <int HD>
__host__ __device__ constexpr int dq_cols() { return HD == 256 ? 2 : 1; }
template <int HD>
__host__ __device__ constexpr int dq_threads() {
  return tc::kWG * dq_groups<HD>() * dq_cols<HD>();
}
template <int HD>
__host__ __device__ constexpr int dq_rows() { return HD == 256 ? 32 : 64; }
template <int HD>
__host__ __device__ constexpr int dq_keys() {
  return HD == 32 ? 64 : HD == 64 ? kDqKeys64 : HD == 128 ? 16 : 8;
}
template <int HD>
__host__ __device__ constexpr int dq_stages() {
  return HD == 64 ? kDqStages64 : 2;
}
// Q and dO hi / lo; the stages of K, V and K^T hi / lo; with CG 2 a tile
// of S and one of dP (BN / 2 values a thread of the first MQ rows)
template <int HD>
constexpr size_t dq_smem() {
  return 4ull * HD * (4 * dq_groups<HD>() * dq_rows<HD>() +
                      dq_stages<HD>() * 6 * dq_keys<HD>()) +
         (dq_cols<HD>() > 1 ? 8ull * dq_rows<HD>() * dq_keys<HD>() : 0);
}

// (a) D = rowsum(dout * o): HD / 8 threads a row, two 16-byte chunks of
// each a thread, added with shuffles.  This kernel and (d) repeat tcb's
// apart from the element type: a template shared with them would change
// the bf16 body's code, which is kept as it is.
template <int HD>
__global__ void __launch_bounds__(256) delta_kernel(const Args a) {
  constexpr int TPR = HD / 8;
  const long long rows = static_cast<long long>(a.B) * a.K * a.G * a.S;
  const long long row =
      static_cast<long long>(blockIdx.x) * (256 / TPR) + threadIdx.x / TPR;
  const int c = threadIdx.x % TPR;
  float acc = 0.f;
  if (row < rows) {
    const float4* x = reinterpret_cast<const float4*>(a.o + row * HD) + 2 * c;
    const float4* y =
        reinterpret_cast<const float4*>(a.dout + row * HD) + 2 * c;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float4 fx = x[i], fy = y[i];
      acc = fmaf(fx.x, fy.x, acc);
      acc = fmaf(fx.y, fy.y, acc);
      acc = fmaf(fx.z, fy.z, acc);
      acc = fmaf(fx.w, fy.w, acc);
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && c == 0) a.delta[row] = acc;
}

// (b) dk and dv of one (b, kv head, key tile, head group).
template <int HD>
__global__ void __launch_bounds__(kv_threads<HD>()) dkdv_kernel(const Args a) {
  constexpr int CG = kv_groups<HD>(), SG = kv_streams<HD>();
  constexpr int MK = kv_keys<HD>(), BM = kv_queries<HD>();
  constexpr int NSS = kv_stages<HD>() / SG;        // stages of a stream
  constexpr int THREADS = kv_threads<HD>(), STHREADS = tc::kWG * CG;
  constexpr int CW = HD / CG;                      // columns a warpgroup
  // each step's dV and dK summed apart (accum3_step) but at HD 256, whose
  // registers hold no more: cuda_lib.bwd_splits keeps its walks short
  constexpr bool kPromote = HD <= 128;
  constexpr bool kPad = MK < tc::kRows;  // wgmma rows past the tile
  constexpr uint32_t KT = MK * HD * 4, QT = BM * HD * 4;
  constexpr uint32_t STAGE = kv_stage_bytes<HD>();
  static_assert(NSS >= 1, "stages");
  extern __shared__ __align__(1024) uint8_t tfb_smem[];
  const uint32_t k_hi = tc::smem_addr(tfb_smem), k_lo = k_hi + KT;
  if (k_hi % 1024) __trap();  // the swizzled tiles need 1024-byte atoms
  const uint32_t v_hi = k_lo + KT, v_lo = v_hi + KT, st0 = v_lo + KT;
  // with two column warpgroups, P^T and dP^T on their way between them
  float* xch = reinterpret_cast<float*>(tfb_smem + 4 * KT +
                                        kv_stages<HD>() * STAGE);

  const int wg = threadIdx.x / tc::kWG, warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int cg = wg % CG, sg = wg / CG;            // columns, stream
  const int stid = threadIdx.x % STHREADS;         // index in the stream
  const int ns = a.splits, grp = blockIdx.x % ns, bk = blockIdx.x / ns;
  const int b = bk / a.K, kv = bk % a.K, H = a.K * a.G;
  const int j0 = blockIdx.y * MK;  // longest tiles (low j0) first
  const int len = a.lengths ? min(max(a.lengths[b], 0), a.S) : a.S;
  const int g0 = a.G * grp / ns, g1 = a.G * (grp + 1) / ns;
  // query i sees key j iff j <= i < j + window, or both are in the
  // prefix (so a key tile that starts there takes queries from 0); a tile
  // past the length has no query
  const int i_start = j0 < a.prefix ? 0 : j0;
  const int i_end = j0 >= len ? i_start
                    : a.window > 0 ? min(a.S, j0 + MK - 1 + a.window)
                                   : a.S;
  const int nt = (i_end - i_start + BM - 1) / BM;  // query tiles a head
  const int steps = (g1 - g0) * nt;
  const size_t kv_off = (static_cast<size_t>(b) * a.K + kv) * a.S * HD;

  // this stream's stage of step t
  auto slot = [&](int t) { return sg * NSS + t / SG % NSS; };
  auto stage = [&](int t) { return st0 + slot(t) * STAGE; };
  auto rows_of = [&](int t) {
    return reinterpret_cast<float*>(tfb_smem + 4 * KT + slot(t) * STAGE +
                                    8 * QT);
  };
  // the stream's barrier (the block's with one stream)
  auto sync = [&]() {
    if constexpr (SG == 1)
      __syncthreads();
    else
      tf::bar_sync(1 + sg, STHREADS);
  };
  // step t's Q and dO rows (and one lse or D a thread) in registers, then
  // split into its stage; rows past S are zeros
  tf::Tile<HD, BM, STHREADS, true, true> qx, dx;
  float rx = 0.f;
  auto fetch_q = [&](int t) {
    const int h = kv * a.G + g0 + t / nt, i0 = i_start + t % nt * BM;
    const size_t qrow = (static_cast<size_t>(b) * H + h) * a.S;
    auto row = [&](const float* base) {
      return [=](int r, bool& ok) {
        ok = i0 + r < a.S;
        return base + (qrow + (ok ? i0 + r : 0)) * HD;
      };
    };
    qx.fetch(stid, row(a.q));
    dx.fetch(stid, row(a.dout));
    const int i = i0 + stid % BM;
    if (stid < 2 * BM)
      rx = i < a.S ? (stid < BM ? a.lse : a.delta)[qrow + i]
                   : (stid < BM ? INFINITY : 0.f);
  };
  auto stash_q = [&](int t) {
    const uint32_t s = stage(t);
    qx.stash(stid, s, s + QT, s + 2 * QT, s + 3 * QT);
    dx.stash(stid, s + 4 * QT, s + 5 * QT, s + 6 * QT, s + 7 * QT);
    if (stid < 2 * BM) rows_of(t)[stid] = rx;
  };

  if (steps > 0) {
    float4 x[tf::kChunks<HD, MK, THREADS>];
    const int n = blockIdx.y;  // the key tile
    tf::fetch<HD, MK, THREADS>(x, threadIdx.x,
                               tf::key_rows<HD, MK>(a.k + kv_off, n, len));
    tf::stash<HD, MK, THREADS, true, false>(x, threadIdx.x, k_hi, k_lo, 0, 0);
    tf::fetch<HD, MK, THREADS>(x, threadIdx.x,
                               tf::key_rows<HD, MK>(a.v + kv_off, n, len));
    tf::stash<HD, MK, THREADS, true, false>(x, threadIdx.x, v_hi, v_lo, 0, 0);
  }
  if (sg < steps) {
    fetch_q(sg);
    stash_q(sg);
  }
  tf::fence_async();
  __syncthreads();  // K and V are the block's

  const float scale_log2 = kLog2e * a.scale;
  // this thread's key rows r0, r0 + 8 of the tile, and query columns c0,
  // c0 + 1 of every 8 of a step
  const int r0 = warp * 16 + lane / 4, c0 = 2 * (lane % 4);
  // the wg's columns of Q^T / dO^T
  const uint32_t col = tf::trans_col<BM>(cg * CW);
  float dk[CW / 2], dv[CW / 2], st[BM / 2], dpt[BM / 2];
#pragma unroll
  for (int i = 0; i < CW / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) st[i] = dpt[i] = 0.f;

  for (int t = sg; t < steps; t += SG) {
    tf::fence_async();
    // step t is in its stage, and the stream is done with the stage's
    // last step
    sync();
    if (t + SG < steps) fetch_q(t + SG);  // in flight during this step
    const int i0 = i_start + t % nt * BM;
    const uint32_t s = stage(t);
    const float* lse_s = rows_of(t);
    const float* d_s = lse_s + BM;

    // P^T in st from S^T: masked only on a tile that straddles the
    // diagonal (or the prefix's edge), the window's edge, the length or S
    auto probs = [&]() {
      // st[4 j + 2 i + e] is key j0 + r0 + 8 i, query i0 + 8 j + c0 + e
      if (kPad || !((i0 >= j0 + MK - 1 ||
                     (i0 + BM <= a.prefix && j0 + MK <= a.prefix)) &&
                    j0 + MK <= len && i0 + BM <= a.S &&
                    (a.window <= 0 || j0 > i0 + BM - 1 - a.window))) {
#pragma unroll
        for (int j = 0; j < BM / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kr = r0 + 8 * (e >> 1), key = j0 + kr;
            const int qi = i0 + 8 * j + c0 + (e & 1);
            if (!(kr < MK && qi < a.S &&
                  tf::attends(qi, key, len, a.prefix, a.window)))
              st[4 * j + e] = -INFINITY;
          }
      }
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const float2 l =
            *reinterpret_cast<const float2*>(lse_s + 8 * j + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[4 * j + e] = tc::ex2(fmaf(st[4 * j + e], scale_log2,
                                       -(e & 1 ? l.y : l.x) * kLog2e));
      }
    };
    uint32_t ph[BM / 8][4], pl[BM / 8][4];
    if constexpr (CG == 1) {
      tc::wg_fence();
      tf::score3<HD, BM>(st, k_hi, k_lo, s, s + QT);  // S^T = K Q^T
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::fence_regs<BM / 2>(st);
      probs();
      tc::wg_fence();  // dP^T = V dO^T, in flight during dV's product
      tf::score3<HD, BM>(dpt, v_hi, v_lo, s + 4 * QT, s + 5 * QT);
      tc::wg_commit();
    } else {
      // Warpgroup 0 computes S^T = K Q^T and P^T, warpgroup 1 dP^T = V
      // dO^T, and each hands its tile to the other through shared memory
      // (a thread to the thread of the same index in the other
      // warpgroup, which holds the same positions), so no score product
      // is done twice.
      tc::wg_fence();
      if (cg == 0)
        tf::score3<HD, BM>(st, k_hi, k_lo, s, s + QT);
      else
        tf::score3<HD, BM>(dpt, v_hi, v_lo, s + 4 * QT, s + 5 * QT);
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::fence_regs<BM / 2>(st);
      tc::fence_regs<BM / 2>(dpt);
      const int wt = threadIdx.x % tc::kWG;
      if (cg == 0) {
        probs();
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) xch[i * tc::kWG + wt] = st[i];
      } else {
#pragma unroll
        for (int i = 0; i < BM / 2; ++i)
          xch[(BM / 2 + i) * tc::kWG + wt] = dpt[i];
      }
      tf::bar_sync(1, THREADS);
      if (cg == 0) {
#pragma unroll
        for (int i = 0; i < BM / 2; ++i)
          dpt[i] = xch[(BM / 2 + i) * tc::kWG + wt];
      } else {
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) st[i] = xch[i * tc::kWG + wt];
      }
    }
    tf::frags<BM>(st, ph, pl);  // dV += P^T dO
    tf::accum3_step<BM, CW, HD, kPromote>(dv, ph, pl, s + 6 * QT + col,
                                          s + 7 * QT + col);
    tc::fence_regs<BM / 2>(dpt);
    // dS^T = P^T (dP^T - D), then dK += dS^T Q
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(d_s + 8 * j + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * j + e] =
            st[4 * j + e] * (dpt[4 * j + e] - (e & 1 ? d.y : d.x));
    }
    tf::frags<BM>(dpt, ph, pl);
    tf::accum3_step<BM, CW, HD, kPromote>(dk, ph, pl, s + 2 * QT + col,
                                          s + 3 * QT + col);
    if constexpr (NSS == 1) sync();  // the stage is read
    if (t + SG < steps) stash_q(t + SG);
  }

  if constexpr (SG > 1) {
    // the later streams' dk and dv through shared memory (K and V's, no
    // longer read), added to stream 0's in stream order
    static_assert(2 * (SG - 1) * CW / 2 * STHREADS * 4 <= 4 * KT, "space");
    float* buf = reinterpret_cast<float*>(tfb_smem);
    __syncthreads();
    if (sg > 0) {
      float* mine = buf + (sg - 1) * CW * STHREADS;
#pragma unroll
      for (int i = 0; i < CW / 2; ++i) {
        mine[i * STHREADS + stid] = dk[i];
        mine[(CW / 2 + i) * STHREADS + stid] = dv[i];
      }
    }
    __syncthreads();
    if (sg > 0) return;
#pragma unroll
    for (int u = 0; u < SG - 1; ++u) {
      const float* other = buf + u * CW * STHREADS;
#pragma unroll
      for (int i = 0; i < CW / 2; ++i) {
        dk[i] += other[i * STHREADS + stid];
        dv[i] += other[(CW / 2 + i) * STHREADS + stid];
      }
    }
  }

  // dk[4 jj + 2 i + e] is key j0 + r0 + 8 i, column cg * CW + 8 jj + c0 + e
  const size_t n = static_cast<size_t>(a.B) * a.K * a.S * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = j0 + r0 + 8 * i;
    if (r0 + 8 * i >= MK || key >= a.S) continue;
    const size_t at = kv_off + static_cast<size_t>(key) * HD + cg * CW + c0;
    const float mul = ns == 1 ? a.scale : 1.f;
    float2* gk = reinterpret_cast<float2*>(
        (ns == 1 ? a.dk : a.part + 2 * grp * n) + at);
    float2* gv = reinterpret_cast<float2*>(
        (ns == 1 ? a.dv : a.part + (2 * grp + 1) * n) + at);
#pragma unroll
    for (int jj = 0; jj < CW / 8; ++jj) {
      gk[4 * jj] = make_float2(dk[4 * jj + 2 * i] * mul,
                               dk[4 * jj + 2 * i + 1] * mul);
      gv[4 * jj] = make_float2(dv[4 * jj + 2 * i], dv[4 * jj + 2 * i + 1]);
    }
  }
}

// (d) dk = scale * sum of the NS groups' partials and dv = their sum, in
// group order: 4 elements a thread.
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
  *reinterpret_cast<float4*>((which ? a.dv : a.dk) + e) =
      make_float4(acc.x * mul, acc.y * mul, acc.z * mul, acc.w * mul);
}

// (c) dq of one (b, head, WG * MQ queries): the forward's walk.
template <int HD>
__global__ void __launch_bounds__(dq_threads<HD>()) dq_kernel(const Args a) {
  constexpr int WG = dq_groups<HD>(), MQ = dq_rows<HD>(), BN = dq_keys<HD>();
  constexpr int NSTAGE = dq_stages<HD>(), CG = dq_cols<HD>(), CW = HD / CG;
  constexpr int THREADS = dq_threads<HD>(), QR = MQ * WG;
  constexpr bool kPad = MQ < tc::kRows;  // wgmma rows past the tile
  constexpr uint32_t QT = MQ * HD * 4;   // a warpgroup's Q, one copy
  constexpr uint32_t KT = BN * HD * 4;   // a key tile, one copy
  extern __shared__ __align__(1024) uint8_t tfb_smem[];
  const uint32_t q_hi = tc::smem_addr(tfb_smem), q_lo = q_hi + WG * QT;
  if (q_hi % 1024) __trap();  // the swizzled tiles need 1024-byte atoms
  const uint32_t do_hi = q_lo + WG * QT, do_lo = do_hi + WG * QT;
  const uint32_t st0 = do_lo + WG * QT;
  // with CG 2, S and dP on their way between the column warpgroups
  float* xch = reinterpret_cast<float*>(tfb_smem + 4 * WG * QT +
                                        NSTAGE * 6 * KT);

  // warpgroup wg of the rows, cg of the columns
  const int wg = threadIdx.x / tc::kWG / CG, cg = threadIdx.x / tc::kWG % CG;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int hq = blockIdx.x, b = blockIdx.y, H = a.K * a.G, kv = hq / a.G;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * QR;  // longest first
  const int len = a.lengths ? min(max(a.lengths[b], 0), a.S) : a.S;
  // Keys any row of the block can attend: [t_lo, t_hi], in tiles n0..n1;
  // and the keys of this warpgroup's MQ rows, [w_lo, w_hi]
  int t_lo, t_hi, w_lo, w_hi;
  tf::key_span(q0, QR, len, a.prefix, a.window, t_lo, t_hi);
  const int n0 = t_lo / BN, n1 = t_hi >= t_lo ? t_hi / BN : n0 - 1;
  const int qw = q0 + MQ * wg;
  tf::key_span(qw, MQ, len, a.prefix, a.window, w_lo, w_hi);

  const size_t qrow = (static_cast<size_t>(b) * H + hq) * a.S;
  const size_t kv_off = (static_cast<size_t>(b) * a.K + kv) * a.S * HD;
  auto stage = [&](int n) { return st0 + (n - n0) % NSTAGE * 6 * KT; };

  {
    float4 x[tf::kChunks<HD, QR, THREADS>];
    auto row = [&](const float* base) {
      return [=](int r, bool& ok) {
        ok = q0 + r < a.S;
        return base + (qrow + (ok ? q0 + r : 0)) * HD;
      };
    };
    tf::fetch<HD, QR, THREADS>(x, threadIdx.x, row(a.q));
    tf::stash<HD, QR, THREADS, true, false>(x, threadIdx.x, q_hi, q_lo, 0, 0);
    tf::fetch<HD, QR, THREADS>(x, threadIdx.x, row(a.dout));
    tf::stash<HD, QR, THREADS, true, false>(x, threadIdx.x, do_hi, do_lo, 0,
                                            0);
  }
  // tile n's K and V rows in registers, then split into its stage: K hi /
  // lo, V hi / lo, K^T hi / lo
  tf::Tile<HD, BN, THREADS, true, true> kx;
  tf::Tile<HD, BN, THREADS, true, false> vx;
  auto fetch_kv = [&](int n) {
    kx.fetch(threadIdx.x, tf::key_rows<HD, BN>(a.k + kv_off, n, len));
    vx.fetch(threadIdx.x, tf::key_rows<HD, BN>(a.v + kv_off, n, len));
  };
  auto stash_kv = [&](int n) {
    const uint32_t s = stage(n);
    kx.stash(threadIdx.x, s, s + KT, s + 4 * KT, s + 5 * KT);
    vx.stash(threadIdx.x, s + 2 * KT, s + 3 * KT, 0, 0);
  };
  if (n0 <= n1) {
    fetch_kv(n0);
    stash_kv(n0);
  }

  const float scale_log2 = kLog2e * a.scale;
  const int rl = warp * 16 + lane / 4;  // this thread's rows of the wg:
  const int r0 = qw + rl;               // rl, rl + 8
  const int c0 = 2 * (lane % 4);        // and columns c0, c0 + 1 of 8
  float lse2[2], dl[2];  // the rows' lse (log2 units) and D
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    const bool in = rl + 8 * i < MQ && row < a.S;
    lse2[i] = in ? a.lse[qrow + row] * kLog2e : INFINITY;
    dl[i] = in ? a.delta[qrow + row] : 0.f;
  }
  float dq[CW / 2], s[BN / 2], dp[BN / 2];
#pragma unroll
  for (int i = 0; i < CW / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;

  for (int n = n0; n <= n1; ++n) {
    tf::fence_async();
    __syncthreads();
    if (n < n1) fetch_kv(n + 1);  // in flight during this tile
    const int k0 = n * BN;
    // a warpgroup skips the tiles none of its rows can attend
    if (!(qw >= a.S || k0 > w_hi || k0 + BN - 1 < w_lo)) {
      const uint32_t k_s = stage(n);
      // S = Q K^T and dP = dO V^T as one wgmma group; with CG 2 the
      // first warpgroup computes S and the second dP, and each hands its
      // tile to the other through shared memory (a thread to the thread
      // of the same index, which holds the same positions; only the
      // first MQ rows), so no score product is done twice
      tc::wg_fence();
      if (CG == 1 || cg == 0)
        tf::score3<HD, BN>(s, q_hi + wg * QT, q_lo + wg * QT, k_s, k_s + KT);
      if (CG == 1 || cg == 1)
        tf::score3<HD, BN>(dp, do_hi + wg * QT, do_lo + wg * QT,
                           k_s + 2 * KT, k_s + 3 * KT);
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::fence_regs<BN / 2>(s);
      tc::fence_regs<BN / 2>(dp);
      // s[4 j + 2 i + e] is row r0 + 8 i, key k0 + 8 j + c0 + e
      if ((CG == 1 || cg == 0) &&
          (kPad || !tf::tile_open(qw, MQ, k0, BN, len, a.prefix, a.window)))
        tf::mask_scores<BN, MQ>(s, r0, rl, k0, c0, len, a.prefix, a.window);
      if constexpr (CG > 1) {
        const int wt = threadIdx.x % tc::kWG;
        constexpr int XT = 2 * MQ;  // threads of the first MQ rows
        if (wt < XT) {
          float* mine = xch + cg * (BN / 2) * XT;
#pragma unroll
          for (int i = 0; i < BN / 2; ++i)
            mine[i * XT + wt] = cg == 0 ? s[i] : dp[i];
        }
        tf::bar_sync(1, THREADS);
        if (wt < XT) {
          const float* other = xch + (1 - cg) * (BN / 2) * XT;
          if (cg == 0) {
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) dp[i] = other[i * XT + wt];
          } else {
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) s[i] = other[i * XT + wt];
          }
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
      uint32_t ph[BN / 8][4], pl[BN / 8][4];
      tf::frags<BN>(s, ph, pl);
      const uint32_t col = tf::trans_col<BN>(cg * CW);  // dq's columns
      tf::accum3_step<BN, CW, HD, true>(dq, ph, pl, k_s + 4 * KT + col,
                                        k_s + 5 * KT + col);  // dQ += dS K
    }
    if constexpr (NSTAGE == 1) __syncthreads();  // the stage is read
    if (n < n1) stash_kv(n + 1);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (rl + 8 * i >= MQ || row >= a.S) continue;
    float2* dst = reinterpret_cast<float2*>(a.dq + (qrow + row) * HD +
                                            cg * CW + c0);
#pragma unroll
    for (int j = 0; j < CW / 8; ++j)
      dst[4 * j] = make_float2(dq[4 * j + 2 * i] * a.scale,
                               dq[4 * j + 2 * i + 1] * a.scale);
  }
}

template <int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t kv_smem = dkdv_smem<HD>(), q_smem = dq_smem<HD>();
  static_assert(kv_smem <= 232448 && q_smem <= 232448, "shared memory");
  // the shared-memory attributes once a device (devices 0-31), as bf16's
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
  constexpr int MK = kv_keys<HD>();
  dkdv_kernel<HD><<<dim3(a.B * a.K * a.splits, (a.S + MK - 1) / MK),
                    kv_threads<HD>(), kv_smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr int QR = dq_rows<HD>() * dq_groups<HD>();
  dq_kernel<HD><<<dim3(H, a.B, (a.S + QR - 1) / QR), dq_threads<HD>(), q_smem,
                  stream>>>(a);
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

}  // namespace tfb
}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v, o, dout, dq, dk and dv alike).
// lengths may be null; window <= 0 means no window; prefix 0 means none
// (0 <= prefix <= S); lse is the forward's float [B, H, S]; delta is float
// [B, H, S] scratch.  splits is NS, the head groups of the dk/dv kernel (1
// to G), and part its float [NS, 2, B, K, S, HD] scratch when NS > 1, else
// null.  Returns the cudaError_t of the launches (0 = success).
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
      prefix < 0 || prefix > S || lse == nullptr)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: {
      const tfb::Args a{static_cast<const float*>(q),
                        static_cast<const float*>(k),
                        static_cast<const float*>(v),
                        static_cast<const float*>(o),
                        static_cast<const float*>(dout),
                        static_cast<const int32_t*>(lengths),
                        static_cast<const float*>(lse),
                        static_cast<float*>(delta), static_cast<float*>(dq),
                        static_cast<float*>(dk), static_cast<float*>(dv),
                        static_cast<float*>(part), B, K, G, S, window, prefix,
                        splits, scale};
      return tfb::by_head_dim(hd, a, st);
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
