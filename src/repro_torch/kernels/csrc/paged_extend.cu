// Paged extend / verify attention for Hopper (sm_90a): Sx query lanes per
// request over a paged KV pool, with a per-lane staircase mask.
//
// Replaces the TPU kernel src/repro/kernels/paged_extend.py
// (paged_extend_attention, body _extend_kernel), which keeps all Sx * G
// rows of a (b, kv head) resident in VMEM while pages stream through a
// sequential grid axis.
//
//   q          [B, Sx, K, G, HD] float or bf16 (HD in {32, 64, 128, 192,
//                                256})
//   k/v pool   [P, ps, K, HD]    same type as q, or int8 with f32 sidecars
//   k/z/v scale[P, ps, K]        int8 only: K = (q + 128) * s + z, V = q * s
//   page_table [B, NP] int32     -1 = unmapped
//   pos0       [B] int32         absolute position of lane 0
//   part       [B, K, splits, Sx * G, HD + 2] float scratch (acc, m, l)
//   out        [B, Sx, K, G, HD] type of q
//
// Lane l sits at pos0 + l and attends slots t <= pos0 + l (and
// t > pos0 + l - window when a window is set); row r of a (b, kv head) is
// lane r / G, query head r % G.  It runs on every prefill chunk and mixed
// step (Sx = prefill_chunk, 32 lanes -> 96 rows at G = 3, 512 at
// recurrentgemma-9b's G = 16) and every speculative verify step (Sx = 1 +
// spec_tokens, 5 lanes -> 15 rows).
//
// What bounds it on the H100: device-memory bytes at verify widths (15
// rows reuse each K/V byte ~15 times: ~15 FLOP per byte, far below the
// ~295 FLOP/byte ridge), and the latency of a block's walk, since B * K
// (b, kv head) pairs are far fewer than the 132 SMs; at a 512-row chunk
// the arithmetic per byte is ~30x higher, which fp32 FMA (67 TFLOP/s)
// could not keep up with.
//
// What the design does about it:
// * bf16 q (dtypes 1 and 3) runs on the tensor cores, with flash_tc.cuh's
//   tile machinery.  A block takes 64 * WG query rows of one (b, kv
//   head), WG = 1 warpgroup when Sx * G <= 64 (verify steps) and 2
//   otherwise (prefill chunks), and walks key tiles of BN slots (64, 32
//   at HD 256): S = Q K^T by wgmma from shared memory, an online softmax
//   in fp32 masked only on tiles that need it (the staircase, the window,
//   unmapped pages, the segment's end), and O += P V with
//   P rounded to bf16 as wgmma's register operand.  Each key tile is
//   gathered from the page table, a row of 16 bytes at a time: bf16
//   pools by cp.async straight into the core-matrix layout, two stages
//   deep; int8 pools into registers one tile ahead, dequantized there and
//   stored as bf16 in the same layout.  Unmapped slots and slots past the
//   segment are zeros and masked.
// * float32 q (dtypes 0 and 2) keeps the fp32 staged walk of
//   paged_common.cuh on tiles of 1024 / HD rows (16 at HD 192 and 256):
//   the 1e-4 checks need fp32 arithmetic, and the walk is bound by bytes.
// * Both split each tile's attendable range [max(0, pos0 + first lane -
//   window + 1), pos0 + last lane] into ``splits`` segments of whole key
//   tiles or stages (cuda_lib.paged_splits: about two blocks per SM over
//   the B * K * tiles rows), a block each, so a verify step's 32 (b, kv
//   head) pairs become 288 blocks; a block stages only its segment's
//   page-table entries and writes its rows' unnormalized (acc, m, l) to
//   ``part``, and paged::combine adds the splits in split order (the same
//   arithmetic as ring and paged decode): bit-identical from run to run.
//   A row with no valid slot gets the TPU kernel's value, the mean of V
//   over its table (paged::PageMean, as in paged decode).
#include "paged_common.cuh"
#include "flash_tc.cuh"

namespace {

namespace tc = flash_tc;

// ------------------------------------------- float32 q: the staged walk

// Rows of a tile: 1024 / HD (8 accumulators per thread), and 16 at HD = 192
// and 256 (24 and 32 accumulators per thread; 1024 / 192 rows would not
// split over the 4 warps).
template <int HD>
constexpr int kRows = HD == 256 || HD == 192 ? 16 : 1024 / HD;

template <typename TKV, int HD>
__global__ void __launch_bounds__(paged::kThreads)
    paged_extend_kernel(paged::Args a, paged::Pages w, float* part,
                        int tiles) {
  extern __shared__ float4 smem[];
  constexpr int TR = kRows<HD>;
  w.split = blockIdx.x / tiles;
  paged::attend_rows<float, TKV, HD, TR>(
      a, w, blockIdx.z, blockIdx.y, blockIdx.x % tiles * TR,
      reinterpret_cast<float*>(smem), paged::Partial{part, w.splits,
                                                      w.split});
}

template <typename TKV, int HD>
cudaError_t launch_walk(const paged::Args& a, paged::Pages w, float* part,
                        cudaStream_t stream) {
  constexpr int TR = kRows<HD>;
  const int tiles = (a.Sx * a.G + TR - 1) / TR;
  w.stage = paged::stage_slots(HD);
  const size_t smem = paged::smem_bytes(HD, TR, w.NP);
  const cudaError_t err =
      paged::allow_smem(paged_extend_kernel<TKV, HD>, smem);
  if (err != cudaSuccess) return err;
  paged_extend_kernel<TKV, HD>
      <<<dim3(tiles * w.splits, a.K, a.B), paged::kThreads, smem, stream>>>(
          a, w, part, tiles);
  const cudaError_t split_err = cudaGetLastError();
  if (split_err != cudaSuccess) return split_err;
  return paged::combine<float, HD>(
      a, part, w.splits, stream,
      paged::PageMean<TKV>{w.page_table, w.ps, w.NP});
}

// ------------------------------------------- bf16 q: the tensor cores

// Shared memory of a tensor-core block: Q [64 WG, HD] and two stages of K
// and V [BN, HD], bf16 core matrices, each stage's slot flags [BN] (does
// the slot hold a row of the segment), then the segment's page-table
// entries (at most NP).
template <int HD, int WG>
size_t tc_smem_bytes(int NP) {
  return tc::smem_bytes<HD, WG>() + tc::kStages * tc::key_tile<HD>() +
         sizeof(int32_t) * NP;
}

template <typename TKV, int HD, int WG>
__global__ void __launch_bounds__(tc::kWG * WG)
    paged_extend_tc_kernel(paged::Args a, paged::Pages w, float* part,
                           int tiles) {
  constexpr int BN = tc::key_tile<HD>();
  constexpr int THREADS = tc::kWG * WG, TR = tc::kRows * WG;
  constexpr uint32_t ROW8 = HD / 8 * 128;     // bytes of 8 rows of a tile
  constexpr uint32_t Q_BYTES = tc::kRows / 8 * ROW8, KV_BYTES = BN / 8 * ROW8;
  constexpr int NCH = BN * HD / 8 / THREADS;  // K (and V) chunks a thread
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  static_assert(BN * HD / 8 % THREADS == 0, "tile must split");
  extern __shared__ __align__(128) uint8_t tc_smem[];
  const uint32_t q_s = tc::smem_addr(tc_smem);
  uint8_t* ok_s = tc_smem + WG * Q_BYTES + tc::kStages * 2 * KV_BYTES;
  int32_t* tbl_s = reinterpret_cast<int32_t*>(ok_s + tc::kStages * BN);
  // byte offset of tile n's K stage; its V stage follows
  auto stage_of = [&](int n) {
    return WG * Q_BYTES + n % tc::kStages * 2 * KV_BYTES;
  };

  const int tile = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int R = a.Sx * a.G, row0 = tile * TR, base = a.pos0[b];
  const int wg = threadIdx.x / tc::kWG, warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;

  // The block's segment of the slots its rows can attend.
  w.split = split;
  w.begin(a, b, h, base + row0 / a.G, base + (min(R, row0 + TR) - 1) / a.G,
          tbl_s);
  __syncthreads();
  const int t_first = w.t_first, t_last = w.t_last;
  const int nt = t_first <= t_last ? (t_last - t_first + BN) / BN : 0;

  const TKV* kp = static_cast<const TKV*>(a.kv_k);
  const TKV* vp = static_cast<const TKV*>(a.kv_v);
  uint2 kq[NCH], vq[NCH];  // int8 tiles: 8 elements a chunk, and their
  float ksr[NCH], kzr[NCH], vsr[NCH];  // slots' scales (bf16: unused)
  // Gather key tile n: each of the thread's chunks from its slot's page
  // (zeros for an unmapped slot or one past the segment), and flag each
  // slot in ok_s.  bf16: one cp.async group into the tile's stage; int8:
  // into registers.  Returns whether any of the thread's slots was such a
  // zero.
  auto fetch = [&](int n) {
    bool bad = false;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      int row, c;
      tc::chunk_of<HD>(idx, row, c);
      const int t = t_first + n * BN + row;
      const long long kv = t <= t_last ? w.row(t) : -1;
      bad |= kv < 0;
      if (c == 0) ok_s[n % tc::kStages * BN + row] = kv >= 0;
      const size_t off = kv >= 0 ? static_cast<size_t>(kv) * HD + 8 * c : 0;
      if constexpr (kQuant) {
        kq[i] = vq[i] = make_uint2(0u, 0u);
        ksr[i] = kzr[i] = vsr[i] = 0.f;
        if (kv >= 0) {
          kq[i] = __ldg(reinterpret_cast<const uint2*>(kp + off));
          vq[i] = __ldg(reinterpret_cast<const uint2*>(vp + off));
          ksr[i] = __ldg(a.ks + kv);
          kzr[i] = __ldg(a.kz + kv);
          vsr[i] = __ldg(a.vs + kv);
        }
      } else {
        const uint32_t dst = q_s + stage_of(n) + 16 * idx;
        tc::cp_async16(dst, kp + off, kv >= 0);
        tc::cp_async16(dst + KV_BYTES, vp + off, kv >= 0);
      }
    }
    if constexpr (!kQuant) tc::cp_async_commit();
    return bad;
  };
  // int8: dequantize the fetched tile n into its stage as bf16.
  auto stash = [&](int n) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const uint32_t kw[2] = {kq[i].x, kq[i].y}, vw[2] = {vq[i].x, vq[i].y};
      uint32_t kb[4], vb[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float kf[2], vf[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int sh = 16 * (e % 2) + 8 * u;
          kf[u] = (static_cast<float>(static_cast<int8_t>(kw[e / 2] >> sh)) +
                   128.f) * ksr[i] + kzr[i];
          vf[u] = static_cast<float>(static_cast<int8_t>(vw[e / 2] >> sh)) *
                  vsr[i];
        }
        kb[e] = tc::pack_bf16(kf[0], kf[1]);
        vb[e] = tc::pack_bf16(vf[0], vf[1]);
      }
      uint8_t* dst = tc_smem + stage_of(n) + 16 * idx;
      *reinterpret_cast<uint4*>(dst) = make_uint4(kb[0], kb[1], kb[2], kb[3]);
      *reinterpret_cast<uint4*>(dst + KV_BYTES) =
          make_uint4(vb[0], vb[1], vb[2], vb[3]);
    }
  };

  // This thread's rows r0, r0 + 8 (flash_tc's accumulator layout) and
  // their positions, and the positions [w_lo, w_hi] of this warpgroup's
  // rows below R.  Rows past R (zero q) are never written, so their
  // scores need no mask.
  const int qw = row0 + tc::kRows * wg;
  const int r0 = qw + warp * 16 + lane / 4, c0 = 2 * (lane % 4);
  const int pos_r[2] = {base + r0 / a.G, base + (r0 + 8) / a.G};
  const int w_lo = base + qw / a.G;
  const int w_hi = base + (min(R, qw + tc::kRows) - 1) / a.G;

  float o[HD / 2], s[BN / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float scale_log2 =
      1.4426950408889634f / sqrtf(static_cast<float>(HD));

  bool bad = false;
  if (nt > 0) {
    // Q's rows (past R: zeros) join key tile 0's loads.
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
    tc::load_rows<HD, TR, THREADS>(q_s, [&](int row, bool& ok) {
      ok = row0 + row < R;
      return q + (ok ? paged::row_offset<HD>(a, b, h, row0 + row) : 0);
    });
    tc::cp_async_commit();
    bad = fetch(0);
    if constexpr (kQuant) stash(0);
  }
  for (int n = 0; n < nt; ++n) {
    tc::cp_async_wait<0>();  // tile n (bf16) and, at n = 0, Q
    // generic-proxy writes (cp.async, st.shared) before wgmma's async reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // tile n is in place, every warpgroup is done with tile n - 1, whose
    // stage tile n + 1 overwrites, and whether any slot of tile n is a zero
    const bool tile_bad = __syncthreads_or(bad);
    if (n + 1 < nt) bad = fetch(n + 1);
    const int k0 = t_first + n * BN, k1 = k0 + BN - 1;
    // a warpgroup skips the tiles none of its rows can attend
    if (qw < R && k0 <= w_hi && (a.window <= 0 || k1 > w_lo - a.window)) {
      const uint32_t k_s = q_s + stage_of(n), v_s = k_s + KV_BYTES;
      tc::score_tile<HD, BN>(s, q_s + wg * Q_BYTES, k_s);
      // s[4 j + 2 i + e] is row r0 + 8 i, slot k0 + 8 j + c0 + e.  Mask
      // only a tile with a zero slot, or the staircase or the window's
      // edge inside it.
      if (tile_bad || k1 > w_lo || (a.window > 0 && k0 <= w_hi - a.window)) {
        const uint8_t* ok = ok_s + n % tc::kStages * BN;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 8 * j + c0 + (e & 1);
            if (!(ok[i] && paged::slot_valid(k0 + i, pos_r[e >> 1],
                                             a.window)))
              s[4 * j + e] = -INFINITY;
          }
      }
      uint32_t p[BN / 16][4];
      tc::softmax_tile<HD, BN>(s, o, m, l, p, scale_log2);
      tc::pv_tile<HD, BN>(o, p, v_s);
    }
    if constexpr (kQuant) {
      if (n + 1 < nt) stash(n + 1);
    }
  }

  // Each valid row's (acc, m, l) in natural-log units (m = max of score *
  // HD^-0.5), as the staged walk writes it; l == 0: m = -inf, no acc.
  float* prow = paged::part_row<HD>(part, a, w.splits, split, b, h, 0);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= R) continue;
    float* dst = prow + static_cast<size_t>(r) * (HD + 2);
    if (l[i] > 0.f) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j + c0) =
            make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
    }
    if (lane % 4 == 0) {
      dst[HD] = l[i] > 0.f ? m[i] * 0.6931471805599453f : -INFINITY;
      dst[HD + 1] = l[i];
    }
  }
}

template <typename TKV, int HD, int WG>
cudaError_t launch_tc(const paged::Args& a, paged::Pages w, float* part,
                      cudaStream_t stream) {
  constexpr int TR = tc::kRows * WG;
  const int tiles = (a.Sx * a.G + TR - 1) / TR;
  w.stage = tc::key_tile<HD>();
  const size_t smem = tc_smem_bytes<HD, WG>(w.NP);
  const cudaError_t err =
      paged::allow_smem(paged_extend_tc_kernel<TKV, HD, WG>, smem);
  if (err != cudaSuccess) return err;
  paged_extend_tc_kernel<TKV, HD, WG>
      <<<dim3(tiles * w.splits, a.K, a.B), tc::kWG * WG, smem, stream>>>(
          a, w, part, tiles);
  const cudaError_t split_err = cudaGetLastError();
  if (split_err != cudaSuccess) return split_err;
  return paged::combine<__nv_bfloat16, HD>(
      a, part, w.splits, stream,
      paged::PageMean<TKV>{w.page_table, w.ps, w.NP});
}

// One warpgroup for verify widths (Sx * G <= 64 rows), two for chunks.
template <typename TKV, int HD>
cudaError_t by_rows_tc(const paged::Args& a, const paged::Pages& w,
                       float* part, cudaStream_t stream) {
  if (a.Sx * a.G <= tc::kRows)
    return launch_tc<TKV, HD, 1>(a, w, part, stream);
  return launch_tc<TKV, HD, 2>(a, w, part, stream);
}

template <int HD>
cudaError_t by_dtype(int dtype, const paged::Args& a, const paged::Pages& w,
                     float* part, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_walk<float, HD>(a, w, part, stream);
    case 1: return by_rows_tc<__nv_bfloat16, HD>(a, w, part, stream);
    case 2: return launch_walk<int8_t, HD>(a, w, part, stream);
    case 3: return by_rows_tc<int8_t, HD>(a, w, part, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32 q and pool, 1 = bf16 q and pool, 2 = f32 q + int8 pool,
// 3 = bf16 q + int8 pool.  window <= 0 means no window.  part holds
// B * K * splits * Sx * G * (hd + 2) floats; splits >= 1.  Returns the
// cudaError_t of the launches (0 = success).
extern "C" int paged_extend(int dtype, const void* q, const void* kp,
                            const void* vp, const void* ks, const void* kz,
                            const void* vs, const void* page_table,
                            const void* pos0, void* out, void* part, int B,
                            int Sx, int K, int G, int hd, int ps, int NP,
                            int window, int splits, void* stream) {
  if (splits < 1) return cudaErrorInvalidValue;
  const paged::Args a{q, kp, vp,
                      static_cast<const float*>(ks),
                      static_cast<const float*>(kz),
                      static_cast<const float*>(vs),
                      static_cast<const int32_t*>(pos0), out,
                      B, Sx, K, G, window,
                      // q, out [B, Sx, K, G, HD]
                      static_cast<long long>(Sx) * K * G,
                      static_cast<long long>(K) * G, G, 1};
  const paged::Pages w{static_cast<const int32_t*>(page_table), ps, NP,
                       splits};
  float* p = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return by_dtype<32>(dtype, a, w, p, st);
    case 64: return by_dtype<64>(dtype, a, w, p, st);
    case 128: return by_dtype<128>(dtype, a, w, p, st);
    case 192: return by_dtype<192>(dtype, a, w, p, st);
    case 256: return by_dtype<256>(dtype, a, w, p, st);
    default: return cudaErrorInvalidValue;
  }
}
