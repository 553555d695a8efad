// Flash attention on Hopper's tensor cores, bf16 (flash_attention.cu,
// dtype 1): the FlashAttention-2 shape written with wgmma.
//
// A block owns 128 consecutive query tokens of one query head h_q of one
// sequence b, as two warpgroups (256 threads) of 64 rows each that share
// every K/V tile staged in shared memory (one warpgroup a block, with
// twice the K/V loads, ran 1.7x slower at chip_smoke.py's flash shapes on
// an H100: scripts/flash_variants.py).  The grid is (H, B, tiles), query
// heads fastest, so the G heads that share a kv head run on neighbouring
// blocks and read its K/V tiles from L2, and the tile index runs
// backwards (longest tiles first).  The block walks the key tiles of BN
// keys (64, or 32 at HD 256) between its first query's window start and
// its last query's diagonal, capped at the sequence's length; a
// warpgroup skips the tiles none of its rows can attend.  Per tile and
// warpgroup:
//
//   S = Q K^T   wgmma m64nBNk16, Q and K from shared memory, fp32 in
//               registers (the accumulator layout: thread t of a
//               warpgroup holds rows 16 (t / 32) + (t % 32) / 4 and 8
//               more, two columns of every 8);
//   softmax     masked (causal, window, length) only on tiles that need
//               it, online in fp32 in the log2 domain (one FFMA and one
//               ex2 a score), row max and sum over the 4 threads of a row
//               with shuffles;
//   O += P V    P rounded to bf16 in registers, used in place as the
//               register A operand of wgmma m64n64k16 (m64n32k16 at HD 32)
//               against V in shared memory; O stays in fp32 registers.
//
// K and V tiles go through a ring of two stages in shared memory with
// 16-byte cp.async, tile n + 1 loading while tile n is computed, and one
// barrier a tile; rows past the sequence's length are zero-filled, never
// read.  Every tile is stored as 8 x 8 "core matrices" of 128 contiguous
// bytes (8 rows of 16 bytes), [rows / 8][HD / 8][8][8]: a warp's cp.async
// writes 512 contiguous bytes (8 rows x 4 chunks, no bank conflict) and
// reads 64 contiguous bytes of each of 8 rows, and the same bytes serve
// as a K-major operand (Q and K: the reduction runs along HD) and as an
// MN-major one (V: the reduction runs along the keys, tnspB = 1), by the
// descriptors' two strides.  A row with no attendable key is zeros.
//
// The bf16 paged extend kernel (paged_extend.cu) runs the same tile on
// key tiles gathered from a page table: it shares the loader
// (chunk_of, load_rows), the descriptors and wgmma wrappers, and the
// three steps of a key tile (score_tile, softmax_tile, pv_tile).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_tc {

constexpr int kWG = 128;     // threads of a warpgroup
constexpr int kRows = 64;    // query rows of a warpgroup: wgmma's M
constexpr int kGroups = 2;   // warpgroups of a block, sharing K/V tiles
// K/V tiles loading while one is computed (two ran no faster:
// scripts/flash_variants.py)
constexpr int kAhead = 1;
constexpr int kStages = kAhead + 1;

struct Args {
  const __nv_bfloat16* q;  // [B, H, S, HD], H = K * G
  const __nv_bfloat16* k;  // [B, K, S, HD]
  const __nv_bfloat16* v;  // [B, K, S, HD]
  const int32_t* lengths;  // [B] valid tokens of each sequence, or null
  __nv_bfloat16* out;      // [B, H, S, HD]
  int B, K, G, S, window;  // window <= 0: no window
};

// Keys of a tile: 64, and 32 at HD 256 (two blocks fit an SM).
template <int HD>
__host__ __device__ constexpr int key_tile() { return HD == 256 ? 32 : 64; }

// Dynamic shared memory: Q [64 * WG, HD], kStages stages of K and V
// [BN, HD].
template <int HD, int WG>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * HD *
         (kRows * WG + 2 * kStages * key_tile<HD>());
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row and 16-byte chunk of chunk idx of a [*, HD] tile in the core-matrix
// layout, where chunk idx lands at byte 16 * idx: a warp's 32 chunks are
// 8 rows x 4 chunks, so its cp.async writes 512 contiguous bytes.
template <int HD>
__device__ __forceinline__ void chunk_of(int idx, int& row, int& c) {
  constexpr int CPR = HD / 8;  // 16-byte chunks of a row
  static_assert(CPR % 4 == 0, "tile");
  const int rest = idx >> 5;
  c = (rest % (CPR / 4)) * 4 + ((idx >> 3) & 3);
  row = (rest / (CPR / 4)) * 8 + (idx & 7);
}

// Rows 0 .. ROWS - 1 of a tile into the core-matrix layout at dst, by the
// block's THREADS threads; ``src(row, ok)`` gives the row's first element
// and sets ok, and a row with ok false is zeros (its address is not read
// but must be a valid one).
template <int HD, int ROWS, int THREADS, typename Src>
__device__ __forceinline__ void load_rows(uint32_t dst, Src src) {
  static_assert((ROWS * HD / 8) % THREADS == 0, "tile");
#pragma unroll
  for (int i = 0; i < ROWS * HD / 8 / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    int row, c;
    chunk_of<HD>(idx, row, c);
    bool ok;
    const __nv_bfloat16* p = src(row, ok);
    cp_async16(dst + 16 * idx, p + 8 * c, ok);
  }
}

// Rows [row0, row0 + ROWS) of a row-major [*, HD] bf16 matrix into the
// core-matrix layout at dst; rows at or past n_valid are zeros.
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, int row0,
                                          int n_valid) {
  load_rows<HD, ROWS, THREADS>(dst, [&](int row, bool& ok) {
    ok = row0 + row < n_valid;
    return src + static_cast<size_t>(ok ? row0 + row : 0) * HD;
  });
}

// wgmma shared-memory descriptor, no swizzle: lbo is the byte stride
// between core matrices along the reduction (K) dimension, sbo along M or
// N.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads of an accumulator above wg_wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void mma_ss_n64(float* d, uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B K-major in shared memory.
__device__ __forceinline__ void mma_ss_n32(float* d, uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (4 bf16 pairs a
// thread), B MN-major in shared memory.
__device__ __forceinline__ void mma_rs_n64(float* d, const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 32] += A[64 x 16] B[16 x 32], A in registers, B MN-major.
__device__ __forceinline__ void mma_rs_n32(float* d, const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// One warpgroup's S = Q K^T over HD in steps of 16 (two core matrices,
// 256 bytes): s [BN / 2] fp32 in the accumulator layout (thread t holds
// rows 16 (t / 32) + (t % 32) / 4 and 8 more, two columns of every 8), Q
// [64, HD] at qw_s and K [BN, HD] at k_s, both K-major core matrices.
template <int HD, int BN>
__device__ __forceinline__ void score_tile(float* s, uint32_t qw_s,
                                           uint32_t k_s) {
  constexpr uint32_t CM = 128, ROW8 = HD / 8 * CM;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t da = desc(qw_s + 256 * kk, CM, ROW8);
    const uint64_t db = desc(k_s + 256 * kk, CM, ROW8);
    if constexpr (BN == 64)
      mma_ss_n64(s, da, db, kk > 0);
    else
      mma_ss_n32(s, da, db, kk > 0);
  }
  wg_commit();
  wg_wait<0>();
  fence_regs<BN / 2>(s);
}

// Online softmax of one masked score tile in the log2 domain, p = 2^(s *
// scale_log2 - m): updates a thread's two rows' running max m (log2 units,
// scaled) and its share of their sums l, rescales o [HD / 2], and packs p
// to bf16 pairs in p [BN / 16][4], the register A fragments of P V.  A
// masked score is -inf; a row with no key yet keeps p = 0.
template <int HD, int BN>
__device__ __forceinline__ void softmax_tile(float* s, float* o, float* m,
                                             float* l, uint32_t (*p)[4],
                                             float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
  float mu[2], corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * scale_log2);
    mu[i] = m_new == -INFINITY ? 0.f : m_new;  // no key yet: p = 0
    corr[i] = ex2(m[i] - mu[i]);
    m[i] = m_new;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], scale_log2, -mu[e >> 1]));
      l[e >> 1] += s[4 * j + e];
    }
    // A fragment of keys 16 (j / 2) ..: (r0, c0), (r0 + 8, c0), then
    // the same 8 keys on
    p[j / 2][2 * (j % 2)] = pack_bf16(s[4 * j], s[4 * j + 1]);
    p[j / 2][2 * (j % 2) + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];
}

// O += P V over a tile's BN keys in steps of 16 (two core matrices along
// the keys, 2 * ROW8 bytes), in pieces of 64 columns of HD: P from
// registers, V [BN, HD] at v_s read MN-major (tnspB = 1).
template <int HD, int BN>
__device__ __forceinline__ void pv_tile(float* o, const uint32_t (*p)[4],
                                        uint32_t v_s) {
  constexpr uint32_t CM = 128, ROW8 = HD / 8 * CM;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    if constexpr (HD == 32) {
      mma_rs_n32(o, p[kk], desc(v_s + 2 * ROW8 * kk, ROW8, CM));
    } else {
#pragma unroll
      for (int pc = 0; pc < HD / 64; ++pc)
        mma_rs_n64(o + 32 * pc, p[kk],
                   desc(v_s + 2 * ROW8 * kk + 8 * CM * pc, ROW8, CM));
    }
  }
  wg_commit();
  wg_wait<0>();
  fence_regs<HD / 2>(o);
}

template <int HD, int WG>
__global__ void __launch_bounds__(kWG * WG)
    flash_tc_kernel(const Args a) {
  constexpr int BN = key_tile<HD>();
  constexpr int THREADS = kWG * WG;
  constexpr uint32_t CM = 128;                // bytes of a core matrix
  constexpr uint32_t ROW8 = HD / 8 * CM;      // bytes of 8 rows of a tile
  constexpr uint32_t Q_BYTES = kRows / 8 * ROW8, KV_BYTES = BN / 8 * ROW8;
  extern __shared__ __align__(128) uint8_t tc_smem[];
  const uint32_t q_s = smem_addr(tc_smem);

  const int wg = threadIdx.x / kWG, warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int hq = blockIdx.x, b = blockIdx.y, h = hq / a.G;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows * WG;  // longest first
  const int len = a.lengths ? min(a.lengths[b], a.S) : a.S;
  // Keys any row of the block can attend: [t_lo, t_hi], in tiles n0..n1.
  const int t_hi = min(q0 + kRows * WG - 1, len - 1);
  const int t_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int n0 = t_lo / BN, n1 = t_hi >= t_lo ? t_hi / BN : n0 - 1;
  // ... and the keys of this warpgroup's 64 rows
  const int qw = q0 + kRows * wg;
  const int w_hi = min(qw + kRows - 1, len - 1);
  const int w_lo = a.window > 0 ? max(0, qw - a.window + 1) : 0;

  const size_t q_off =
      (static_cast<size_t>(b) * a.K * a.G + hq) * a.S * HD;
  const size_t kv_off = (static_cast<size_t>(b) * a.K + h) * a.S * HD;
  const __nv_bfloat16* kg = a.k + kv_off;
  const __nv_bfloat16* vg = a.v + kv_off;
  const uint32_t qw_s = q_s + wg * Q_BYTES;
  auto k_stage = [&](int n) {
    return q_s + WG * Q_BYTES + (n - n0) % kStages * 2 * KV_BYTES;
  };
  // Tile n's K and V as one cp.async group (empty past the last tile).
  auto load_kv = [&](int n) {
    if (n <= n1) {
      load_tile<HD, BN, THREADS>(k_stage(n), kg, n * BN, len);
      load_tile<HD, BN, THREADS>(k_stage(n) + KV_BYTES, vg, n * BN, len);
    }
    cp_async_commit();
  };

  load_tile<HD, kRows * WG, THREADS>(q_s, a.q + q_off, q0, a.S);
#pragma unroll
  for (int i = 0; i < kAhead; ++i) load_kv(n0 + i);  // Q joins the first

  const float scale_log2 =
      1.4426950408889634f / sqrtf(static_cast<float>(HD));
  const int r0 = qw + warp * 16 + lane / 4;  // this thread's rows: r0, r0 + 8
  const int c0 = 2 * (lane % 4);             // and columns c0, c0 + 1 of 8
  float o[HD / 2], s[BN / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
  // running max (log2 units, scaled) and this thread's share of the sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int n = n0; n <= n1; ++n) {
    cp_async_wait<kAhead - 1>();  // tile n; the later ones may still load
    // cp.async writes are generic-proxy; wgmma reads through the async one
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // tile n is in place, and every warpgroup is done with tile n - 1,
    // whose stage the load of tile n + kAhead overwrites
    __syncthreads();
    load_kv(n + kAhead);
    const int k0 = n * BN;
    // a warpgroup skips the tiles none of its rows can attend
    if (qw >= a.S || k0 > w_hi || k0 + BN - 1 < w_lo) continue;
    const uint32_t k_s = k_stage(n), v_s = k_s + KV_BYTES;

    score_tile<HD, BN>(s, qw_s, k_s);

    // s[4 j + 2 i + e] is row r0 + 8 i, key k0 + 8 j + c0 + e.  Mask only
    // a tile that straddles the diagonal, the window's edge or the length.
    if (!(k0 + BN - 1 <= qw && k0 + BN <= len &&
          (a.window <= 0 || k0 > qw + kRows - 1 - a.window))) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + 8 * (e >> 1);
          const int key = k0 + 8 * j + c0 + (e & 1);
          if (!(key <= row && key < len &&
                (a.window <= 0 || key > row - a.window)))
            s[4 * j + e] = -INFINITY;
        }
    }
    uint32_t p[BN / 16][4];
    softmax_tile<HD, BN>(s, o, m, l, p, scale_log2);
    pv_tile<HD, BN>(o, p, v_s);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = r0 + 8 * i;
    if (row >= a.S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        a.out + q_off + static_cast<size_t>(row) * HD + c0);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      dst[4 * j] =
          pack_bf16(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
  }
}

}  // namespace flash_tc
