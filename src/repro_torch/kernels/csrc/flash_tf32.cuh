// Flash attention in fp32 on Hopper's tensor cores, as 3xTF32 products
// (flash_attention.cu and flash_attention_bwd.cu, dtype 0): the pieces both
// fp32 bodies share, and the forward kernel.
//
// Why three products.  A TF32 product keeps 10 bits of each input's
// mantissa (2^-11 relative), too coarse for fp32 attention (held to 1e-4).
// Each fp32 value x is split in registers into hi = tf32(x) and lo =
// tf32(x - hi), both rounded to nearest (cvt.rna.tf32.f32); then a b =
// lo_a hi_b + hi_a lo_b + hi_a hi_b, and what is lost (lo_a lo_b and the
// rounding of the lo terms) is about 2^-21 of |a b|.  The three products
// go into the same fp32 accumulators, small terms first, as CUTLASS's
// OpMultiplyAddFastF32 does and as PyTorch's memory-efficient SDPA runs
// fp32.  At 495 TFLOP/s of TF32 that is an effective 165 TFLOP/s, 2.5x the
// 67 TFLOP/s of fp32 FMA on the CUDA cores.
//
// The layout (where the design is shaped by the instruction).  wgmma with
// tf32 operands takes both A and B K-major (the reduction dimension
// contiguous): it has no transpose bits, unlike bf16.  So:
//   * a tile whose reduction runs along HD (Q, K, dO and V in S = Q K^T,
//     dP = dO V^T and their transposes) is stored as it lies in memory,
//     [R / 8][HD / 4] core matrices of 8 rows x 16 bytes (asis_off);
//   * a tile whose reduction runs along its rows (V in O += P V; dO and Q
//     in dV += P^T dO and dK += dS^T Q; K in dQ += dS K) is stored
//     transposed, the R positions contiguous: from 32 positions on in
//     wgmma's 128-byte swizzle (trans_sw_off), shorter ones as [HD / 8]
//     [R / 4] plain core matrices (trans_off);
//   * the operand produced in registers (P, P^T, dS, dS^T) is wgmma's A
//     from registers.  The accumulator gives thread t of a quad columns
//     2t and 2t + 1 of every 8, while a tf32 A fragment wants columns t
//     and t + 4.  Rather than shuffle, every transposed tile stores its
//     rows permuted within each 8 (row 2t + u at position t + 4u, perm()),
//     so the accumulator's registers are the A fragment as they stand
//     (frags()): the reduction's order is the same permutation on both
//     sides.
// Tiles are split and, where needed, transposed on their way in: each
// thread loads rows into registers one tile ahead (fetch), then splits
// them into hi and lo and stores the copies (stash, Tile).  A warp's
// 16-byte stores of an as-is tile are 8 rows x 4 chunks, no bank
// conflict.  A swizzled transposed tile is built from 4 x 4 blocks a
// thread, transposed in registers and stored 16 bytes at a time, no
// conflict; a short one by 4-byte stores whose four columns rotate with
// the lane, so the 32 lanes of one store hit 32 banks.  (The 4-byte form
// everywhere took a third of the forward's and the backward's time on an
// H100: scripts/flash_f32_variants.py, ablate-trans-stores.)
//
// What bounds it on the H100: operations, 3 x 4 HD FLOP a (query, key)
// pair at 495 TFLOP/s of TF32.  What holds it below that: the staging
// above runs on the CUDA cores beside the products (without it the
// forward takes about 0.6 of its time at whisper's encoder shape), and
// each product group is waited for before the softmax that reads it.
//
// The forward kernel (fwd_kernel) is flash_tc.cuh's walk in fp32: a block
// of WG warpgroups of 64 query rows of one head, key tiles of BN keys
// between the block's first window start and its last diagonal (or the
// prefix's last key) through a two-stage ring in shared memory, one
// barrier a tile, longest tiles first; per tile and warpgroup
//   S = Q K^T      3 x HD / 8 wgmma m64nBNk8, A (Q hi / lo) and B (K hi /
//                  lo) from shared memory;
//   softmax        masked only where a tile straddles an edge, online in
//                  fp32 registers, ex2 in the log2 domain;
//   O += P V       3 x BN / 8 wgmma m64n64k8 (m64n32k8 at HD 32) a piece
//                  of 64 columns, P hi / lo from registers, V^T hi / lo
//                  from shared memory; up to HD 64 into zeroed registers
//                  added into O by fp32 adds (accum3_step).
// Q hi / lo stay in shared memory; a stage holds K hi / lo and V^T hi /
// lo.  With lse non-null it also stores each row's log-sum-exp (natural
// log; +inf for a row with no key), as flash_tc.cuh does.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace flash_tf32 {

namespace tc = flash_tc;

constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const float* q;          // [B, H, S, HD], H = K * G
  const float* k;          // [B, K, S, HD]
  const float* v;          // [B, K, S, HD]
  const int32_t* lengths;  // [B] valid tokens of each sequence, or null
  float* out;              // [B, H, S, HD]
  float* lse;              // [B, H, S] each row's log-sum-exp, or null
  int B, K, G, S, window;  // window <= 0: no window
  int prefix;              // tokens t < prefix attend each other both
                           // ways (0: none)
};

// ------------------------------------------------------ the split, tiles

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// x = hi + lo (to about 2^-21 of x), both tf32.
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

__device__ __forceinline__ void st_shared4(uint32_t addr, float a, float b,
                                           float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, float a) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(a) : "memory");
}

__device__ __forceinline__ void fence_async() {
  // generic-proxy stores into shared memory, before wgmma reads them
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier ``id`` (1-15; 0 is __syncthreads) of ``threads`` threads.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Byte offset of chunk c (columns 4c .. 4c + 3) of row r in an as-is tile
// of [*, HD] fp32: [R / 8][HD / 4][8][4]; 8 rows are HD * 32 bytes apart.
template <int HD>
__device__ __forceinline__ uint32_t asis_off(int r, int c) {
  return ((r >> 3) * (HD / 4) + c) * 128 + (r & 7) * 16;
}

// Position of tile row r in a transposed tile: row 2t + u of each 8 at t +
// 4u, so that a thread's accumulator columns 2t, 2t + 1 are the A
// fragment's t and t + 4.
__device__ __forceinline__ int perm(int r) {
  return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
}

// Byte offset of (column d, position p) in a transposed tile of R
// positions: [HD / 8][R / 4][8][4]; 8 columns are R * 32 bytes apart.
template <int R>
__device__ __forceinline__ uint32_t trans_off(int d, int p) {
  return ((d >> 3) * (R / 4) + (p >> 2)) * 128 + (d & 7) * 16 + (p & 3) * 4;
}

// Byte offset of (column d, position p) in a transposed tile of NT columns
// in wgmma's 128-byte swizzle (positions 32 or more): atoms of 8 columns x
// 32 positions (128 bytes), the 16-byte chunk of each 4 positions XORed
// with the column's index in its 8; atoms of one 32 positions stacked over
// the NT columns (1024 bytes apart), the next 32 positions NT / 8 atoms
// on.  Tiles start on 1024 bytes.
template <int NT>
__device__ __forceinline__ uint32_t trans_sw_off(int d, int p) {
  return ((p >> 5) * (NT / 8) + (d >> 3)) * 1024 + (d & 7) * 128 +
         ((((p & 31) >> 2) ^ (d & 7)) << 4) + (p & 3) * 4;
}

// Byte offset of column d0 (a multiple of 8) of a transposed tile of R
// positions.
template <int R>
__host__ __device__ constexpr uint32_t trans_col(int d0) {
  return R >= 32 ? d0 * 128 : d0 * R * 4;
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle: 8 rows
// 1024 bytes apart (the leading byte offset is unused).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// Row and chunk of chunk idx of a tile: a warp's 32 chunks are 8 rows x 4
// chunks (flash_tc::chunk_of at the byte width of an fp32 row).
template <int HD>
__device__ __forceinline__ void chunk_rc(int idx, int& r, int& c) {
  constexpr int CPR = HD / 4;  // 16-byte chunks of a row
  static_assert(CPR % 4 == 0, "tile");
  const int w = idx >> 5, lane = idx & 31;
  r = (w / (CPR / 4)) * 8 + (lane & 7);
  c = (w % (CPR / 4)) * 4 + (lane >> 3);
}

template <int HD, int R, int THREADS>
constexpr int kChunks = R * HD / 4 / THREADS;  // chunks a thread

// Rows 0 .. R - 1 of a tile into registers x, by THREADS threads (tid
// this one's index among them, warps whole); ``src(row, ok)`` gives the
// row's first element and sets ok, and a row with ok false is zeros (not
// read).
template <int HD, int R, int THREADS, typename Src>
__device__ __forceinline__ void fetch(float4* x, int tid, Src src) {
  static_assert((R * HD / 4) % THREADS == 0, "tile");
#pragma unroll
  for (int i = 0; i < kChunks<HD, R, THREADS>; ++i) {
    int r, c;
    chunk_rc<HD>(tid + i * THREADS, r, c);
    bool ok;
    const float* p = src(r, ok);
    x[i] = ok ? __ldg(reinterpret_cast<const float4*>(p) + c)
              : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ float pick(const float* v, int j) {
  return j == 0 ? v[0] : j == 1 ? v[1] : j == 2 ? v[2] : v[3];
}

// The fetched rows split into hi and lo: as-is at hi / lo (ASIS) and
// transposed at thi / tlo (TRANS).
template <int HD, int R, int THREADS, bool ASIS, bool TRANS>
__device__ __forceinline__ void stash(const float4* x, int tid, uint32_t hi,
                                      uint32_t lo, uint32_t thi,
                                      uint32_t tlo) {
  const int lane = tid & 31;
  // lane bits 1-2 give a row's p & 3 and bit 3 its column's d & 4; bits 0
  // and 4 rotate the four columns, so a store's 32 lanes hit 32 banks
  const int rot = (lane & 1) | ((lane >> 3) & 2);
#pragma unroll
  for (int i = 0; i < kChunks<HD, R, THREADS>; ++i) {
    int r, c;
    chunk_rc<HD>(tid + i * THREADS, r, c);
    float h[4], l[4];
    split(x[i].x, h[0], l[0]);
    split(x[i].y, h[1], l[1]);
    split(x[i].z, h[2], l[2]);
    split(x[i].w, h[3], l[3]);
    if constexpr (ASIS) {
      const uint32_t o = asis_off<HD>(r, c);
      st_shared4(hi + o, h[0], h[1], h[2], h[3]);
      st_shared4(lo + o, l[0], l[1], l[2], l[3]);
    }
    if constexpr (TRANS) {
      const int p = perm(r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = (e + rot) & 3;
        const uint32_t o = trans_off<R>(4 * c + j, p);
        st_shared(thi + o, pick(h, j));
        st_shared(tlo + o, pick(l, j));
      }
    }
  }
}

// A tile of R rows on its way into shared memory: its rows fetched into
// registers (fetch), then split into hi and lo and stored as they lie
// (ASIS) and transposed (TRANS) (stash).  A transposed tile of 32 or more
// positions is built from 4 x 4 blocks a thread (rows 8 g + u + 2 t, t =
// 0 .. 3, of 4 columns: perm() puts them at positions 8 g + 4 u + t),
// transposed in registers and stored 16 bytes at a time into the
// swizzled layout (trans_sw_off): a quarter warp's 8 lanes (u, g % 4) hit
// 8 chunks, no bank conflict, and no selects; its as-is copy then has
// 4-way conflicts.  Shorter tiles go by 16-byte chunks (stash above).
template <int HD, int R, int THREADS, bool ASIS, bool TRANS>
struct Tile {
  static constexpr bool kBlocks = TRANS && R >= 32;
  static constexpr int kBlockCount = R * HD / 16;
  static constexpr int kUnits = (kBlockCount + THREADS - 1) / THREADS;
  static constexpr int kN = kBlocks ? 4 * kUnits : kChunks<HD, R, THREADS>;
  float4 x[kN];

  // Block idx: lane bits 0 (u) and 1-2 (g % 4), 3-4 (c % 4).
  __device__ __forceinline__ static void block_of(int idx, int& g, int& u,
                                                  int& c) {
    const int w = idx >> 5, lane = idx & 31;
    u = lane & 1;
    g = 4 * (w % (R / 32)) + ((lane >> 1) & 3);
    c = 4 * (w / (R / 32)) + (lane >> 3);
  }

  template <typename Src>
  __device__ __forceinline__ void fetch(int tid, Src src) {
    if constexpr (kBlocks) {
      static_assert(R % 32 == 0 && HD % 16 == 0, "tile");
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        const int idx = tid + i * THREADS;
        int g, u, c;
        block_of(idx, g, u, c);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          bool ok;
          const float* p = src(8 * g + u + 2 * t, ok);
          x[4 * i + t] = ok && idx < kBlockCount
                             ? __ldg(reinterpret_cast<const float4*>(p) + c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    } else {
      flash_tf32::fetch<HD, R, THREADS>(x, tid, src);
    }
  }

  __device__ __forceinline__ void stash(int tid, uint32_t hi, uint32_t lo,
                                        uint32_t thi, uint32_t tlo) const {
    if constexpr (kBlocks) {
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        const int idx = tid + i * THREADS;
        if (kUnits * THREADS > kBlockCount && idx >= kBlockCount) continue;
        int g, u, c;
        block_of(idx, g, u, c);
        float h[4][4], l[4][4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float4 v = x[4 * i + t];
          split(v.x, h[t][0], l[t][0]);
          split(v.y, h[t][1], l[t][1]);
          split(v.z, h[t][2], l[t][2]);
          split(v.w, h[t][3], l[t][3]);
          if constexpr (ASIS) {
            const uint32_t o = asis_off<HD>(8 * g + u + 2 * t, c);
            st_shared4(hi + o, h[t][0], h[t][1], h[t][2], h[t][3]);
            st_shared4(lo + o, l[t][0], l[t][1], l[t][2], l[t][3]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t o = trans_sw_off<HD>(4 * c + e, 8 * g + 4 * u);
          st_shared4(thi + o, h[0][e], h[1][e], h[2][e], h[3][e]);
          st_shared4(tlo + o, l[0][e], l[1][e], l[2][e], l[3][e]);
        }
      }
    } else {
      flash_tf32::stash<HD, R, THREADS, ASIS, TRANS>(x, tid, hi, lo, thi,
                                                      tlo);
    }
  }
};

// ------------------------------------------------- wgmma with tf32 inputs

// d[64 x 8] (+)= A[64 x 8] B[8 x 8], tf32 in, fp32 accumulate; A and B
// K-major in shared memory.
__device__ __forceinline__ void ss_n8(float* d, uint64_t da, uint64_t db,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 16] (+)= A[64 x 8] B[8 x 16], tf32 in, fp32 accumulate; A and B
// K-major in shared memory.
__device__ __forceinline__ void ss_n16(float* d, uint64_t da, uint64_t db,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 32] (+)= A[64 x 8] B[8 x 32], tf32 in, fp32 accumulate; A and B
// K-major in shared memory.
__device__ __forceinline__ void ss_n32(float* d, uint64_t da, uint64_t db,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 8] B[8 x 64], tf32 in, fp32 accumulate; A and B
// K-major in shared memory.
__device__ __forceinline__ void ss_n64(float* d, uint64_t da, uint64_t db,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 32] += A[64 x 8] B[8 x 32], A in registers (4 tf32 a thread), B
// K-major in shared memory.
__device__ __forceinline__ void rs_n32(float* d, const uint32_t* a,
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 8] B[8 x 64], A in registers (4 tf32 a thread), B
// K-major in shared memory.
__device__ __forceinline__ void rs_n64(float* d, const uint32_t* a,
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, "
      "1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void mma_ss(float* d, uint64_t da, uint64_t db,
                                       int accumulate) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64, "shape");
  if constexpr (N == 8) ss_n8(d, da, db, accumulate);
  if constexpr (N == 16) ss_n16(d, da, db, accumulate);
  if constexpr (N == 32) ss_n32(d, da, db, accumulate);
  if constexpr (N == 64) ss_n64(d, da, db, accumulate);
}

// d[64 x N] = A[64 x HD] B[N x HD]^T over HD, 3xTF32: A's and B's hi and
// lo as-is tiles (8 rows HD * 32 bytes apart).  Only issued: the caller
// fences before, commits, waits and fences d after.
template <int HD, int N>
__device__ __forceinline__ void score3(float* d, uint32_t a_hi, uint32_t a_lo,
                                       uint32_t b_hi, uint32_t b_lo) {
  constexpr uint32_t SBO = HD * 32;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const uint32_t o = 256 * kk;  // 8 columns: two core matrices
    mma_ss<N>(d, tc::desc(a_lo + o, 128, SBO), tc::desc(b_hi + o, 128, SBO),
              kk > 0);
    mma_ss<N>(d, tc::desc(a_hi + o, 128, SBO), tc::desc(b_lo + o, 128, SBO),
              1);
    mma_ss<N>(d, tc::desc(a_hi + o, 128, SBO), tc::desc(b_hi + o, 128, SBO),
              1);
  }
}

// A [64 x KD] accumulator tile (thread t of a quad: columns 2t, 2t + 1 of
// every 8) as tf32 A fragments hi / lo [KD / 8][4]: a0, a1 are rows r0,
// r0 + 8 at position t, a2, a3 at t + 4, which the transposed B tiles
// hold as columns 2t and 2t + 1 (perm).
template <int KD>
__device__ __forceinline__ void frags(const float* s, uint32_t (*ph)[4],
                                      uint32_t (*pl)[4]) {
#pragma unroll
  for (int kk = 0; kk < KD / 8; ++kk) {
    const float v[4] = {s[4 * kk], s[4 * kk + 2], s[4 * kk + 1],
                        s[4 * kk + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float h, l;
      split(v[e], h, l);
      ph[kk][e] = __float_as_uint(h);
      pl[kk][e] = __float_as_uint(l);
    }
  }
}

// d[64 x PW] += P[64 x KD] X[KD x PW], 3xTF32, PW 32 or 64: P as
// fragments ph / pl, X as a transposed tile of KD positions and NT columns
// (swizzled from 32 positions on), x_hi / x_lo at its first of the PW
// columns taken (trans_col).  Only issued.
template <int KD, int PW, int NT>
__device__ __forceinline__ void accum3(float* d, const uint32_t (*ph)[4],
                                       const uint32_t (*pl)[4], uint32_t x_hi,
                                       uint32_t x_lo) {
  constexpr bool SW = KD >= 32;
  constexpr uint32_t SBO = KD * 32;  // 8 columns, unswizzled
  static_assert(PW == 32 || PW == 64, "shape");
#pragma unroll
  for (int kk = 0; kk < KD / 8; ++kk) {
    uint64_t dh, dl;
    if constexpr (SW) {
      const uint32_t o = kk / 4 * (NT / 8) * 1024 + kk % 4 * 32;
      dh = desc_sw128(x_hi + o);
      dl = desc_sw128(x_lo + o);
    } else {
      dh = tc::desc(x_hi + 256 * kk, 128, SBO);
      dl = tc::desc(x_lo + 256 * kk, 128, SBO);
    }
    if constexpr (PW == 64) {
      rs_n64(d, pl[kk], dh);
      rs_n64(d, ph[kk], dl);
      rs_n64(d, ph[kk], dh);
    } else {
      rs_n32(d, pl[kk], dh);
      rs_n32(d, ph[kk], dl);
      rs_n32(d, ph[kk], dh);
    }
  }
}

// d[64 x NC] += P[64 x KD] X[KD x NC] in pieces of 64 columns (32 at NC
// 32), issued and waited for (with every wgmma group in flight).  The
// tensor cores round each add into an accumulator toward zero, so a walk
// of many steps summed there drifts: 3 to 25 times the error of fp32 adds
// at whisper's, internvl2's and recurrentgemma's shapes on an H100, past
// the 1e-4 bound of the backward at internvl2's (scripts/
// flash_f32_variants.py, no-promote; scripts/flash_tf32_error.py's
// emulation gives the same drift).  With PROMOTE each piece's products
// are summed from zero in PW / 2 more registers and added into d by fp32
// adds, one wait a piece, so that the tensor cores' sums are one step
// long; without, where the kernel's registers hold no more (the forward
// from HD 128, dk / dv at HD 256), d takes them all in one group.
template <int KD, int NC, int NT, bool PROMOTE>
__device__ __forceinline__ void accum3_step(float* d, const uint32_t (*ph)[4],
                                            const uint32_t (*pl)[4],
                                            uint32_t x_hi, uint32_t x_lo) {
  constexpr int PW = NC < 64 ? NC : 64;
  if constexpr (!PROMOTE) {
    tc::wg_fence();
#pragma unroll
    for (int pc = 0; pc < NC / PW; ++pc)
      accum3<KD, PW, NT>(d + PW / 2 * pc, ph, pl,
                         x_hi + trans_col<KD>(PW * pc),
                         x_lo + trans_col<KD>(PW * pc));
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::fence_regs<NC / 2>(d);
  } else {
#pragma unroll
    for (int pc = 0; pc < NC / PW; ++pc) {
      float t[PW / 2];
#pragma unroll
      for (int i = 0; i < PW / 2; ++i) t[i] = 0.f;
      const uint32_t c = trans_col<KD>(PW * pc);
      tc::wg_fence();
      accum3<KD, PW, NT>(t, ph, pl, x_hi + c, x_lo + c);
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::fence_regs<PW / 2>(t);
#pragma unroll
      for (int i = 0; i < PW / 2; ++i) d[PW / 2 * pc + i] += t[i];
    }
  }
}

// Online softmax of one masked fp32 score tile in the log2 domain, in
// place (s becomes p = 2^(s * scale_log2 - m)): flash_tc::softmax_tile
// without the bf16 packing.
template <int HD, int BN>
__device__ __forceinline__ void softmax_tile(float* s, float* o, float* m,
                                             float* l, float scale_log2) {
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
    corr[i] = tc::ex2(m[i] - mu[i]);
    m[i] = m_new;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = tc::ex2(fmaf(s[4 * j + e], scale_log2, -mu[e >> 1]));
      l[e >> 1] += s[4 * j + e];
    }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];
}

// ------------------------------------- the key walk (forward and dq)

// Whether query ``row`` attends ``key``: causal, or both in the prefix,
// inside the window and the length.
__device__ __forceinline__ bool attends(int row, int key, int len,
                                        int prefix, int window) {
  return (key <= row || (row < prefix && key < prefix)) && key < len &&
         (window <= 0 || key > row - window);
}

// The keys rows q0 .. q0 + rows - 1 can attend: [lo, hi] (empty when hi <
// lo); rows in the prefix reach its last key as well as their diagonal.
__device__ __forceinline__ void key_span(int q0, int rows, int len,
                                         int prefix, int window, int& lo,
                                         int& hi) {
  hi = min(max(q0 + rows - 1, q0 < prefix ? prefix - 1 : 0), len - 1);
  lo = window > 0 ? max(0, q0 - window + 1) : 0;
}

// Whether every row qw .. qw + rows - 1 attends every key k0 .. k0 + bn -
// 1 (no mask needed): below the diagonal or inside the prefix, the length
// and the window.
__device__ __forceinline__ bool tile_open(int qw, int rows, int k0, int bn,
                                          int len, int prefix, int window) {
  return (k0 + bn - 1 <= qw || (qw + rows <= prefix && k0 + bn <= prefix)) &&
         k0 + bn <= len && (window <= 0 || k0 > qw + rows - 1 - window);
}

// Scores s of a [64 x BN] accumulator tile (s[4 j + 2 i + e] is row r0 +
// 8 i, key k0 + 8 j + c0 + e) set to -inf where the row does not attend
// the key, and, with MQ < 64, on wgmma's rows past the first MQ (rl is
// r0's row in the warpgroup).
template <int BN, int MQ>
__device__ __forceinline__ void mask_scores(float* s, int r0, int rl, int k0,
                                            int c0, int len, int prefix,
                                            int window) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e >> 1);
      const bool in = MQ >= 64 || rl + 8 * (e >> 1) < MQ;
      if (!(in && attends(row, k0 + 8 * j + c0 + (e & 1), len, prefix,
                          window)))
        s[4 * j + e] = -INFINITY;
    }
}

// Row r of key tile n of a [S, HD] sequence at base (ok false, and row 0
// given, past len): a fetch source.
template <int HD, int BN>
__device__ __forceinline__ auto key_rows(const float* base, int n, int len) {
  return [=](int r, bool& ok) {
    const int t = n * BN + r;
    ok = t < len;
    return base + static_cast<size_t>(ok ? t : 0) * HD;
  };
}

// ------------------------------------------------------------ the forward

// Warpgroups of a block (sharing its key tiles), keys of a tile and
// stages, so that Q hi / lo and the stages of K and V^T hi / lo fit 227
// KB: 192 KB at HD 128, 192 and 256 (one block an SM), 96 KB at HD 32 and
// 64 (two); scripts/flash_f32_variants.py times the other values at HD 64.
// At HD 192, 32 keys would take 288 KB and 16 take 192 KB: 16.
constexpr int kFwdGroups64 = 2;
constexpr int kFwdKeys64 = 64;
constexpr int kFwdStages64 = 2;
template <int HD>
__host__ __device__ constexpr int fwd_groups() {
  return HD == 32 ? 2 : HD == 64 ? kFwdGroups64 : 1;
}
template <int HD>
__host__ __device__ constexpr int fwd_keys() {
  return HD == 32    ? 64
         : HD == 64  ? kFwdKeys64
         : HD == 128 ? 32
         : HD == 192 ? 16
                     : 8;
}
template <int HD>
__host__ __device__ constexpr int fwd_stages() {
  return HD == 64 ? kFwdStages64 : 2;
}
template <int HD>
__host__ __device__ constexpr size_t fwd_smem() {
  return 4ull * HD * (2 * tc::kRows * fwd_groups<HD>() +
                      fwd_stages<HD>() * 4 * fwd_keys<HD>());
}

template <int HD>
__global__ void __launch_bounds__(tc::kWG * fwd_groups<HD>())
    fwd_kernel(const Args a) {
  constexpr int WG = fwd_groups<HD>(), BN = fwd_keys<HD>();
  constexpr int NSTAGE = fwd_stages<HD>();
  constexpr int THREADS = tc::kWG * WG, QR = tc::kRows * WG;
  constexpr uint32_t QT = tc::kRows * HD * 4;  // a warpgroup's Q, one copy
  constexpr uint32_t KT = BN * HD * 4;         // a key tile, one copy
  extern __shared__ __align__(1024) uint8_t tf_smem[];
  const uint32_t q_hi = tc::smem_addr(tf_smem), q_lo = q_hi + WG * QT;
  if (q_hi % 1024) __trap();  // the swizzled tiles need 1024-byte atoms
  const uint32_t st0 = q_lo + WG * QT;

  const int wg = threadIdx.x / tc::kWG, warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int hq = blockIdx.x, b = blockIdx.y, h = hq / a.G;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * QR;  // longest first
  const int len = a.lengths ? min(a.lengths[b], a.S) : a.S;
  // Keys any row of the block can attend: [t_lo, t_hi], in tiles n0..n1;
  // and the keys of this warpgroup's 64 rows, [w_lo, w_hi]
  int t_lo, t_hi, w_lo, w_hi;
  key_span(q0, QR, len, a.prefix, a.window, t_lo, t_hi);
  const int n0 = t_lo / BN, n1 = t_hi >= t_lo ? t_hi / BN : n0 - 1;
  const int qw = q0 + tc::kRows * wg;
  key_span(qw, tc::kRows, len, a.prefix, a.window, w_lo, w_hi);

  const size_t q_off = (static_cast<size_t>(b) * a.K * a.G + hq) * a.S * HD;
  const size_t kv_off = (static_cast<size_t>(b) * a.K + h) * a.S * HD;
  auto stage = [&](int n) { return st0 + (n - n0) % NSTAGE * 4 * KT; };

  {
    float4 x[kChunks<HD, QR, THREADS>];
    fetch<HD, QR, THREADS>(x, threadIdx.x, [&](int r, bool& ok) {
      ok = q0 + r < a.S;
      return a.q + q_off + static_cast<size_t>(ok ? q0 + r : 0) * HD;
    });
    stash<HD, QR, THREADS, true, false>(x, threadIdx.x, q_hi, q_lo, 0, 0);
  }
  // tile n's K and V rows in registers, then split into its stage
  Tile<HD, BN, THREADS, true, false> kt;
  Tile<HD, BN, THREADS, false, true> vt;
  auto fetch_kv = [&](int n) {
    kt.fetch(threadIdx.x, key_rows<HD, BN>(a.k + kv_off, n, len));
    vt.fetch(threadIdx.x, key_rows<HD, BN>(a.v + kv_off, n, len));
  };
  auto stash_kv = [&](int n) {
    const uint32_t s = stage(n);
    kt.stash(threadIdx.x, s, s + KT, 0, 0);
    vt.stash(threadIdx.x, 0, 0, s + 2 * KT, s + 3 * KT);
  };
  if (n0 <= n1) {
    fetch_kv(n0);
    stash_kv(n0);
  }

  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(HD));
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
    fence_async();
    // tile n is in its stage, and every warpgroup is done with tile n - 1,
    // whose stage tile n + 1 goes into at the end of this step
    __syncthreads();
    if (n < n1) fetch_kv(n + 1);  // in flight during this tile
    const int k0 = n * BN;
    // a warpgroup skips the tiles none of its rows can attend
    if (!(qw >= a.S || k0 > w_hi || k0 + BN - 1 < w_lo)) {
      const uint32_t k_s = stage(n);
      tc::wg_fence();
      score3<HD, BN>(s, q_hi + wg * QT, q_lo + wg * QT, k_s, k_s + KT);
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::fence_regs<BN / 2>(s);
      // mask only a tile that straddles the diagonal (or the prefix's
      // edge), the window's edge or the length
      if (!tile_open(qw, tc::kRows, k0, BN, len, a.prefix, a.window))
        mask_scores<BN, tc::kRows>(s, r0, 0, k0, c0, len, a.prefix, a.window);
      softmax_tile<HD, BN>(s, o, m, l, scale_log2);
      uint32_t ph[BN / 8][4], pl[BN / 8][4];
      frags<BN>(s, ph, pl);
      accum3_step<BN, HD, HD, HD <= 64>(o, ph, pl, k_s + 2 * KT,
                                         k_s + 3 * KT);
    }
    if constexpr (NSTAGE == 1) __syncthreads();  // the stage is read
    if (n < n1) stash_kv(n + 1);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = r0 + 8 * i;
    if (row >= a.S) continue;
    if (a.lse != nullptr && lane % 4 == 0)  // log2 units back to natural
      a.lse[q_off / HD + row] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * 0.6931471805599453f
                     : INFINITY;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float2* dst = reinterpret_cast<float2*>(
        a.out + q_off + static_cast<size_t>(row) * HD + c0);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      dst[4 * j] = make_float2(o[4 * j + 2 * i] * inv,
                               o[4 * j + 2 * i + 1] * inv);
  }
}

}  // namespace flash_tf32
