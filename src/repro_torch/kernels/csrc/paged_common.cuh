// Shared staged walk of the attention kernels that run on the CUDA cores:
// paged decode (replaces src/repro/kernels/paged_attention.py), paged
// extend in float32 and int8 with float32 q (paged_extend.py; bf16 extend
// runs on the tensor cores, paged_extend.cu) and ring decode
// (decode_attention.py).  One thread block owns a tile of query rows of
// one (request b, kv head h) pair and walks the K/V slots those rows can
// attend.  Where a slot's K/V row lives is the kernel's "walk" (below): a
// page table over shared pools (Pages) or a dense ring whose tok array
// names each slot's token (Ring).
//
// What bounds them on the H100: device-memory bytes (a few FLOP per K/V
// byte against a ridge of ~295), so what matters is how many blocks keep
// loads in flight.
//
// The walk goes in stages of S = 4096 / HD slots (64 at HD = 64), but at
// least 32 (32 at HD = 128, 192 and 256), whatever the page size.  Each thread
// loads its share of a stage's K and V rows as 16-byte vectors into
// registers one stage ahead, so the device memory reads of stage n + 1 are
// in flight while stage n is computed, then dequantizes them (int8 caches)
// and stores them as float into shared memory.  So every slot is read from
// device memory once per block, whatever the number of rows in the tile.
// Per stage each warp scores its rows against the stage's slots (a lane per
// slot, fp32 FMA), folds them into the online softmax of those rows with
// warp shuffles (m and l in registers), and then every thread adds p.V to
// its share of the fp32 [rows, HD] accumulator.  Three barriers per stage.
//
// The result of a row goes out as a Partial: the unnormalized (acc, m, l)
// of one segment of a walk split across blocks, which combine() then adds
// up in split order.  The paged walks split a tile's attendable range into
// whole stages (segment()), a ring into equal runs of slots.  A split walk
// covers a short segment, so it also stages q with 16-byte loads issued
// before its slot list and adds p.V slot by slot, each V vector read once
// for all of a thread's rows.
//
// Masking is position arithmetic, as in the TPU kernels: row r is query
// lane r / G at absolute position pos0[b] + r / G.  Pages: slot t holds
// token t and is valid iff it holds a row (a mapped page) and t <= pos
// (and t > pos - window when a window is set).  Ring: the walk first lists
// the slots of its segment whose token the block's single query position
// may attend (tok >= 0, tok <= pos, tok > pos - window) and walks that
// list.  Slots no row of the tile can attend are never read.  A row with
// no valid slot ends with l == 0 (Partial: m = -inf, l = 0); combine()
// then writes what its Empty policy says: the mean of V over the row's
// page table for the paged kernels, as their TPU kernels give it
// (PageMean), zeros otherwise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace paged {

constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX kernels
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStageElems = 4096;       // K (and V) elements of one stage
constexpr int kMaxSmem = 232448;        // opt-in shared memory of a block

struct Args {
  const void* q;         // query rows, at the offsets row_offset() gives
  const void* kv_k;      // K rows [*, HD], 16-byte aligned
  const void* kv_v;      // V rows [*, HD], 16-byte aligned
  const float* ks;       // int8 K scale, one per K row (null for fp caches)
  const float* kz;       // int8 K zero point
  const float* vs;       // int8 V scale
  const int32_t* pos0;   // [B], absolute position of lane 0 (null: 0)
  void* out;             // like q
  int B, Sx, K, G, window;  // window <= 0: no window
  // Query / output row (b, lane, kv head h, g) starts at element
  // HD * (b * sb + lane * sl + h * sh + g * sg).
  long long sb, sl, sh, sg;
};

// Slots of one stage: 4096 / HD, but at least one slot a lane when
// scoring (HD = 192 and 256: 32 slots, 6144 and 8192 elements).
__host__ __device__ constexpr int stage_slots(int HD) {
  return kStageElems / HD > 32 ? kStageElems / HD : 32;
}

__host__ __device__ constexpr int gcd(int a, int b) {
  return b == 0 ? a : gcd(b, a % b);
}

// Dynamic shared memory of a block of TR rows with a walk table of NT
// entries (page-table entries or ring slots).
__host__ __device__ constexpr size_t smem_bytes(int HD, int TR, int NT) {
  return sizeof(float) * (TR * HD                          // q
                          + stage_slots(HD) * (HD + 4)     // K, padded
                          + stage_slots(HD) * HD           // V
                          + TR * stage_slots(HD)           // p
                          + 2 * TR)                        // rescale, l
         + sizeof(int32_t) * NT;                           // walk table
}

// Allow a kernel the dynamic shared memory it is launched with.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The 16 / sizeof(T) pool elements of a 16-byte vector, as floats.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u,
                                                      float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __bfloat162float(
        __ushort_as_bfloat16(static_cast<unsigned short>(w[i] & 0xffffu)));
    f[2 * i + 1] = __bfloat162float(
        __ushort_as_bfloat16(static_cast<unsigned short>(w[i] >> 16)));
  }
}
template <>
__device__ __forceinline__ void unpack<int8_t>(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = static_cast<float>(static_cast<int8_t>(w[i / 4] >> (8 * (i % 4))));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool slot_valid(int t, int pos, int window) {
  return t <= pos && (window <= 0 || t > pos - window);
}

// Element offset of row r = (lane, g) of (b, h) in q and out.
template <int HD>
__device__ __forceinline__ size_t row_offset(const Args& a, int b, int h,
                                             int r) {
  const int lane = r / a.G, g = r % a.G;
  return static_cast<size_t>(HD) *
         (b * a.sb + lane * a.sl + h * a.sh + g * a.sg);
}

// ----------------------------------------------------------------- walks
// A walk names the K/V rows of a block's slots t = t_first .. t_last:
//   begin(a, b, h, p_first, p_last, tbl) sets that range for query rows at
//     positions p_first .. p_last, staging what it needs into the int
//     table tbl in shared memory (attend_rows synchronizes after it);
//   row(t) is the K/V row index of slot t in range, or -1 if it holds none;
//   attendable(t, pos): may a row at position pos (-1: a padding row)
//     attend slot t, given row(t) >= 0.

// Segment ``split`` of ``splits`` of the slot range [t_first, t_last], in
// whole stages of ``stage`` slots counted from t_first: of the range's n
// stages, stages [split * n / splits, (split + 1) * n / splits).  A
// segment that gets no stage is left empty (t_first > t_last).
__device__ __forceinline__ void segment(int& t_first, int& t_last, int stage,
                                        int splits, int split) {
  if (t_first > t_last) return;
  const int n = (t_last - t_first + stage) / stage;
  const int lo = split * n / splits, hi = (split + 1) * n / splits;
  t_last = min(t_last, t_first + hi * stage - 1);
  t_first += lo * stage;
}

// Pools [P, ps, K, HD] of pages, mapped per request by a page table.  The
// rows' attendable range [max(0, p_first - window + 1), min(p_last,
// NP * ps - 1)] splits into ``splits`` segments of whole stages; a block
// walks segment ``split`` and stages only its page-table entries.
struct Pages {
  const int32_t* page_table;  // [B, NP], -1 = unmapped
  int ps, NP, splits, stage;  // stage: slots per stage of the block's walk
  int split;
  int t_first, t_last, j0, K, h, window;
  const int32_t* tbl;         // page-table entries j0 .. t_last / ps

  __device__ void begin(const Args& a, int b, int h_, int p_first,
                        int p_last, int32_t* tbl_s) {
    K = a.K;
    h = h_;
    window = a.window;
    tbl = tbl_s;
    t_last = min(p_last, NP * ps - 1);
    t_first = window > 0 ? max(0, p_first - window + 1) : 0;
    segment(t_first, t_last, stage, splits, split);
    j0 = t_first / ps;
    if (t_first <= t_last)
      for (int j = j0 + threadIdx.x; j <= t_last / ps; j += blockDim.x)
        tbl_s[j - j0] = page_table[static_cast<size_t>(b) * NP + j];
  }
  __device__ long long row(int t) const {
    const int phys = tbl[t / ps - j0];
    return phys < 0 ? -1
                    : (static_cast<long long>(phys) * ps + t % ps) * K + h;
  }
  __device__ bool attendable(int t, int pos) const {
    return slot_valid(t, pos, window);
  }
};

// A dense ring [B, C, K, HD] per request; tok [B, C] holds the absolute
// token of each slot (-1 = empty).  One query position per block.  The
// ring splits into ``splits`` segments: a block walks the slots of segment
// ``split``, [split * C / splits, (split + 1) * C / splits).
struct Ring {
  const int32_t* tok;
  int C, splits, split;
  int t_first, t_last, K, h;
  long long base;             // first ring row of request b
  const int32_t* idx;         // the attendable slots, in ring order

  __device__ void begin(const Args& a, int b, int h_, int p_first,
                        int p_last, int32_t* tbl_s) {
    __shared__ int warp_n[kWarps];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int c_lo = static_cast<int>(static_cast<long long>(split) * C /
                                      splits);
    const int c_hi = static_cast<int>(static_cast<long long>(split + 1) *
                                      C / splits);
    K = a.K;
    h = h_;
    base = static_cast<long long>(b) * C;
    idx = tbl_s;
    // List the segment's slots whose token position p_last may attend,
    // kThreads slots a round, in ring order (a ballot per warp, then the
    // warps' counts in order): deterministic, so sums do not vary between
    // runs.
    int n = 0;
    for (int c0 = c_lo; c0 < c_hi; c0 += kThreads) {
      const int c = c0 + threadIdx.x;
      const int t = c < c_hi ? tok[base + c] : -1;
      const bool ok = t >= 0 && slot_valid(t, p_last, a.window);
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) warp_n[warp] = __popc(m);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? warp_n[w] : 0;
        total += warp_n[w];
      }
      if (ok) tbl_s[n + before + __popc(m & ((1u << lane) - 1u))] = c;
      n += total;
      __syncthreads();  // warp_n is rewritten in the next round
    }
    t_first = 0;
    t_last = n - 1;
  }
  __device__ long long row(int t) const { return (base + idx[t]) * K + h; }
  __device__ bool attendable(int, int pos) const { return pos >= 0; }
};

// ------------------------------------------------------------ epilogues
// Where attend_rows puts each row's result.
// Partial: one split of the walk's unnormalized result, float [HD + 2] =
// (acc, m, l) at row ((b * K + h) * splits + split) * Sx * G + r of part
// (part_row); where l == 0, m is -inf and acc is not written (combine()
// skips it).
struct Partial {
  float* part;
  int splits, split;
};

// Row r of (b, h) in split ``split``'s partials, [HD + 2] floats.
template <int HD>
__device__ __forceinline__ float* part_row(float* part, const Args& a,
                                           int splits, int split, int b,
                                           int h, int r) {
  return part + static_cast<size_t>(HD + 2) *
                    (((static_cast<size_t>(b) * a.K + h) * splits + split) *
                         a.Sx * a.G + r);
}

// Attend rows [row0, row0 + TR) of (b, h) over the slots of ``w``; rows
// past Sx * G are padding.
template <typename TQ, typename TKV, int HD, int TR, typename Walk>
__device__ void attend_rows(const Args& a, Walk w, int b, int h, int row0,
                            float* smem, Partial epi) {
  constexpr int S = stage_slots(HD);      // slots per stage
  constexpr int SPL = S / 32;             // slots per lane when scoring
  constexpr int RPW = TR / kWarps;        // rows per warp when scoring
  constexpr int KST = HD + 4;             // padded K row: conflict-free
  constexpr int VEC = 16 / sizeof(TKV);   // pool elements per 16-byte load
  constexpr int CPR = HD / VEC;           // 16-byte loads per K or V row
  constexpr int NV = S * CPR / kThreads;  // loads per thread per stage
  constexpr int CH = HD / 4;              // float4 columns of a row
  constexpr int NC = (TR * CH + kThreads - 1) / kThreads;
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  static_assert(S % 32 == 0 && TR % kWarps == 0, "tile must split");
  static_assert((S * CPR) % kThreads == 0, "stage must split");

  const TQ* q = static_cast<const TQ*>(a.q);
  const uint4* kp = static_cast<const uint4*>(a.kv_k);
  const uint4* vp = static_cast<const uint4*>(a.kv_v);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int R = a.Sx * a.G;

  float* q_s = smem;              // [TR][HD], pre-scaled by HD^-0.5
  float* k_s = q_s + TR * HD;     // [S][KST] the stage's K rows
  float* v_s = k_s + S * KST;     // [S][HD]  the stage's V rows
  float* p_s = v_s + S * HD;      // [TR][S]  the stage's probabilities
  float* c_s = p_s + TR * S;      // [TR] the stage's rescale factor
  float* l_s = c_s + TR;          // [TR] final denominators
  int32_t* tbl_s = reinterpret_cast<int32_t*>(l_s + TR);  // the walk's

  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  const int base = a.pos0 ? a.pos0[b] : 0;

  // A split walk covers a short segment, so the latency of staging q is
  // a large share of it: its q rows are loaded 16 bytes at a time, all
  // issued before the walk lists its slots.
  constexpr int QV = 16 / sizeof(TQ);     // q elements per 16-byte load
  constexpr int NQ = (TR * HD / QV + kThreads - 1) / kThreads;
  uint4 qr[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int c = (tid + i * kThreads) * QV, r = row0 + c / HD;
    qr[i] = c < TR * HD && r < R
                ? *reinterpret_cast<const uint4*>(
                      q + row_offset<HD>(a, b, h, r) + c % HD)
                : make_uint4(0u, 0u, 0u, 0u);
  }

  // Slots any row of the tile can attend: [w.t_first, w.t_last].
  const int last = min(R, row0 + TR) - 1;
  w.begin(a, b, h, base + row0 / a.G, base + last / a.G, tbl_s);
  const int t_first = w.t_first, t_last = w.t_last;
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int c = (tid + i * kThreads) * QV;
    if (c < TR * HD) {
      float f[QV];
      unpack<TQ>(qr[i], f);
#pragma unroll
      for (int e = 0; e < QV; ++e) q_s[c + e] = f[e] * scale;
    }
  }
  __syncthreads();

  uint4 kr[NV], vr[NV];
  float ksr[NV], kzr[NV], vsr[NV];  // int8 sidecars of each load's slot

  // Issue the loads of the stage starting at slot t0.
  auto fetch = [&](int t0) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int idx = tid + v * kThreads;
      const int t = t0 + idx / CPR;
      const long long slot = t <= t_last ? w.row(t) : -1;
      kr[v] = vr[v] = make_uint4(0u, 0u, 0u, 0u);
      ksr[v] = kzr[v] = vsr[v] = 0.f;
      if (slot >= 0) {
        kr[v] = __ldg(kp + slot * CPR + idx % CPR);
        vr[v] = __ldg(vp + slot * CPR + idx % CPR);
        if constexpr (kQuant) {
          ksr[v] = __ldg(a.ks + slot);
          kzr[v] = __ldg(a.kz + slot);
          vsr[v] = __ldg(a.vs + slot);
        }
      }
    }
  };

  // Dequantize the loaded stage into k_s and v_s (zeros where not loaded).
  auto stash = [&]() {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int idx = tid + v * kThreads;
      const int sl = idx / CPR, c0 = (idx % CPR) * VEC;
      float kf[VEC], vf[VEC];
      unpack<TKV>(kr[v], kf);
      unpack<TKV>(vr[v], vf);
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        if constexpr (kQuant) {
#pragma unroll
          for (int u = e; u < e + 4; ++u) {
            kf[u] = (kf[u] + 128.f) * ksr[v] + kzr[v];
            vf[u] = vf[u] * vsr[v];
          }
        }
        *reinterpret_cast<float4*>(k_s + sl * KST + c0 + e) =
            make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
        *reinterpret_cast<float4*>(v_s + sl * HD + c0 + e) =
            make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
      }
    }
  };

  float m[RPW], l[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float4 acc[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);

  if (t_first <= t_last) fetch(t_first);
  for (int t0 = t_first; t0 <= t_last; t0 += S) {
    stash();
    __syncthreads();
    if (t0 + S <= t_last) fetch(t0 + S);  // in flight during this stage

    // Scores: rows warp + kWarps * i against slots lane + 32 * k.
    float sc[RPW][SPL];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int k = 0; k < SPL; ++k) sc[i][k] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 kv[SPL];
#pragma unroll
      for (int k = 0; k < SPL; ++k)
        kv[k] = *reinterpret_cast<const float4*>(
            k_s + (lane + 32 * k) * KST + d);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(
            q_s + (warp + kWarps * i) * HD + d);
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          float s = sc[i][k];
          s = fmaf(qv.x, kv[k].x, s);
          s = fmaf(qv.y, kv[k].y, s);
          s = fmaf(qv.z, kv[k].z, s);
          s = fmaf(qv.w, kv[k].w, s);
          sc[i][k] = s;
        }
      }
    }

    bool mapped[SPL];
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int t = t0 + lane + 32 * k;
      mapped[k] = t <= t_last && w.row(t) >= 0;
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int rl = warp + kWarps * i, r = row0 + rl;
      const int pos = r < R ? base + r / a.G : -1;  // padding: no valid slot
      bool ok[SPL];
      float mx = kNegInf;
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        ok[k] = mapped[k] && w.attendable(t0 + lane + 32 * k, pos);
        if (ok[k]) mx = fmaxf(mx, sc[i][k]);
      }
      const float m_new = fmaxf(m[i], warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const float p = ok[k] ? expf(sc[i][k] - m_new) : 0.f;
        p_s[rl * S + lane + 32 * k] = p;
        sum += p;
      }
      m[i] = m_new;
      l[i] = l[i] * corr + warp_sum(sum);
      if (lane == 0) c_s[rl] = corr;
    }
    __syncthreads();

    // acc = acc * corr + p . V over the stage's slots that exist.
    const int n = (min(S, t_last - t0 + 1) + 3) & ~3;
    if constexpr (kThreads % CH == 0) {
      // Slot-outer: a thread's accumulators share one column d (CH
      // divides kThreads), so each V vector is read once for all its rows.
      const int d = (tid % CH) * 4;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const float corr = c_s[min((tid + k * kThreads) / CH, TR - 1)];
        acc[k].x *= corr;
        acc[k].y *= corr;
        acc[k].z *= corr;
        acc[k].w *= corr;
      }
      for (int t = 0; t < n; ++t) {
        const float4 v4 = *reinterpret_cast<const float4*>(v_s + t * HD + d);
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const int rl = min((tid + k * kThreads) / CH, TR - 1);
          const float pe = p_s[rl * S + t];
          acc[k].x = fmaf(pe, v4.x, acc[k].x);
          acc[k].y = fmaf(pe, v4.y, acc[k].y);
          acc[k].z = fmaf(pe, v4.z, acc[k].z);
          acc[k].w = fmaf(pe, v4.w, acc[k].w);
        }
      }
    } else {
      // HD = 192: CH = 48 columns do not divide the 128 threads, so the
      // column of accumulator k, (tid + k * kThreads) % CH, cycles through
      // NCOL = CH / gcd(kThreads, CH) columns (3): the thread reads those
      // NCOL V vectors a slot, each once for all its rows.
      constexpr int NCOL = CH / gcd(kThreads, CH);
      int d[NCOL];
#pragma unroll
      for (int j = 0; j < NCOL; ++j) d[j] = (tid + j * kThreads) % CH * 4;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const float corr = c_s[min((tid + k * kThreads) / CH, TR - 1)];
        acc[k].x *= corr;
        acc[k].y *= corr;
        acc[k].z *= corr;
        acc[k].w *= corr;
      }
      for (int t = 0; t < n; ++t) {
        float4 v4[NCOL];
#pragma unroll
        for (int j = 0; j < NCOL; ++j)
          v4[j] = *reinterpret_cast<const float4*>(v_s + t * HD + d[j]);
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const int rl = min((tid + k * kThreads) / CH, TR - 1);
          const float pe = p_s[rl * S + t];
          const float4 v = v4[k % NCOL];
          acc[k].x = fmaf(pe, v.x, acc[k].x);
          acc[k].y = fmaf(pe, v.y, acc[k].y);
          acc[k].z = fmaf(pe, v.z, acc[k].z);
          acc[k].w = fmaf(pe, v.w, acc[k].w);
        }
      }
    }
    __syncthreads();  // the next stage overwrites k_s, v_s, p_s and c_s
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i)
    if (lane == 0) l_s[warp + kWarps * i] = l[i];
  __syncthreads();

  float* part = part_row<HD>(epi.part, a, epi.splits, epi.split, b, h, 0);
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = row0 + warp + kWarps * i;
    if (lane == 0 && r < R) {
      part[static_cast<size_t>(r) * (HD + 2) + HD] =
          l[i] > 0.f ? m[i] : -INFINITY;
      part[static_cast<size_t>(r) * (HD + 2) + HD + 1] = l[i];
    }
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = tid + k * kThreads;
    const int rl = c / CH, d = (c % CH) * 4, r = row0 + rl;
    if (c < TR * CH && r < R && l_s[rl] > 0.f) {
      float2* dst = reinterpret_cast<float2*>(
          part + static_cast<size_t>(r) * (HD + 2) + d);
      dst[0] = make_float2(acc[k].x, acc[k].y);
      dst[1] = make_float2(acc[k].z, acc[k].w);
    }
  }
}

// ----------------------------------------------------------- empty rows
// What combine() writes for a row that no split attended (l = 0 in all),
// columns d and d + 1 of row (b, h).  Every thread of the block calls it.

// ZeroRow: zeros (ring decode).
struct ZeroRow {
  template <int HD>
  __device__ float2 fill(const Args&, int, int, int) const {
    return make_float2(0.f, 0.f);
  }
};

// Columns d, d + 1 of V row ``row`` of a [*, HD] pool of TKV, as floats
// (int8: times the row's scale).
template <typename TKV, int HD>
__device__ __forceinline__ float2 v_pair(const Args& a, long long row,
                                         int d) {
  const TKV* v = static_cast<const TKV*>(a.kv_v) + row * HD + d;
  if constexpr (std::is_same<TKV, float>::value) {
    return *reinterpret_cast<const float2*>(v);
  } else if constexpr (std::is_same<TKV, __nv_bfloat16>::value) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(v));
  } else {
    const char2 c = *reinterpret_cast<const char2*>(v);
    const float s = a.vs[row];
    return make_float2(c.x * s, c.y * s);
  }
}

// PageMean: the paged kernels.  Their TPU kernels (paged_attention.py,
// paged_extend.py) DMA physical page 0 for an unmapped table entry and
// mask every score of a row with no valid slot alike, so such a row
// attends all NP * ps slots of its table uniformly: it gets the mean of
// their V, page 0's for each unmapped entry.  An idle batch slot (a table
// with no page) gets page 0's mean, and an MoE decode step routes it
// beside the live rows.  The block counts the unmapped entries together
// (__syncthreads_count); each thread then adds its two columns over the
// mapped pages, if any, and page 0 once for all unmapped ones.
template <typename TKV>
struct PageMean {
  const int32_t* page_table;  // [B, NP], -1 = unmapped
  int ps, NP;

  template <int HD>
  __device__ float2 page_sum(const Args& a, int phys, int h, int d) const {
    float2 s = make_float2(0.f, 0.f);
    for (int i = 0; i < ps; ++i) {
      const float2 v = v_pair<TKV, HD>(
          a, (static_cast<long long>(phys) * ps + i) * a.K + h, d);
      s.x += v.x;
      s.y += v.y;
    }
    return s;
  }

  template <int HD>
  __device__ float2 fill(const Args& a, int b, int h, int d) const {
    const int32_t* tbl = page_table + static_cast<size_t>(b) * NP;
    int unmapped = 0;
    for (int j0 = 0; j0 < NP; j0 += blockDim.x) {
      const int j = j0 + threadIdx.x;
      unmapped += __syncthreads_count(j < NP && tbl[j] < 0);
    }
    float2 s = make_float2(0.f, 0.f);
    if (d < HD) {
      if (unmapped < NP)
        for (int j = 0; j < NP; ++j) {
          const int phys = tbl[j];
          if (phys >= 0) {
            const float2 p = page_sum<HD>(a, phys, h, d);
            s.x += p.x;
            s.y += p.y;
          }
        }
      if (unmapped > 0) {
        const float2 p = page_sum<HD>(a, 0, h, d);
        s.x += unmapped * p.x;
        s.y += unmapped * p.y;
      }
    }
    const float inv = 1.f / (static_cast<float>(NP) * ps);
    return make_float2(s.x * inv, s.y * inv);
  }
};

// One block per output row (b, h, r) of the R = Sx * G rows of each (b,
// h): the splits' partials [B, K, splits, R, HD + 2] added up in split
// order,
//
//   out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s,  M = max m_s,
//
// skipping splits with no slot (l = 0); a row with none gets the Empty
// policy's fill (its l is the same in every thread of the block).  A
// thread a split reads (m_s, l_s) into shared memory and turns them into
// the weight e^(m_s - M) and its weighted l; then thread t sums dims 2t,
// 2t + 1 of the weighted acc over the splits, its loads independent of
// one another, and writes the row where row_offset() puts it.  The order
// is fixed, so results are bit-identical from run to run, and one split
// gives acc / l exactly.
template <typename TQ, int HD, typename Empty>
__global__ void __launch_bounds__(HD / 2 > 32 ? HD / 2 : 32)
    combine_kernel(const float* part, Args a, int splits, Empty empty) {
  extern __shared__ float w_s[];  // [splits] m_s, then weights
  float* wl_s = w_s + splits;     // [splits] l_s, then weighted
  const int R = a.Sx * a.G;
  const int row = blockIdx.x, bh = row / R, r = row % R;
  const float* p =
      part + (static_cast<size_t>(bh) * splits * R + r) * (HD + 2);
  const size_t stride = static_cast<size_t>(R) * (HD + 2);
  for (int s = threadIdx.x; s < splits; s += blockDim.x) {
    const float2 ml = *reinterpret_cast<const float2*>(p + s * stride + HD);
    w_s[s] = ml.y > 0.f ? ml.x : -INFINITY;
    wl_s[s] = ml.y;
  }
  __syncthreads();
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, w_s[s]);
  __syncthreads();
  for (int s = threadIdx.x; s < splits; s += blockDim.x) {
    const float w = w_s[s] == -INFINITY ? 0.f : expf(w_s[s] - M);
    w_s[s] = w;
    wl_s[s] *= w;
  }
  __syncthreads();
  float l = 0.f;
  for (int s = 0; s < splits; ++s) l += wl_s[s];
  const int d = 2 * threadIdx.x;
  const int b = bh / a.K, h = bh % a.K;
  if (!(l > 0.f)) {                 // no split attended a slot
    const float2 e = empty.template fill<HD>(a, b, h, d);
    if (d < HD) {
      TQ* dst = static_cast<TQ*>(a.out) + row_offset<HD>(a, b, h, r) + d;
      store(dst, e.x);
      store(dst + 1, e.y);
    }
    return;
  }
  if (d < HD) {
    float2 o = make_float2(0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      const float w = w_s[s];
      if (w > 0.f) {
        const float2 x =
            *reinterpret_cast<const float2*>(p + s * stride + d);
        o.x += w * x.x;
        o.y += w * x.y;
      }
    }
    TQ* dst = static_cast<TQ*>(a.out) + row_offset<HD>(a, b, h, r) + d;
    store(dst, o.x / l);
    store(dst + 1, o.y / l);
  }
}

// Launch combine_kernel over the B * K * Sx * G rows of ``a``; a row no
// split attended gets ``empty``'s fill.
template <typename TQ, int HD, typename Empty = ZeroRow>
cudaError_t combine(const Args& a, const float* part, int splits,
                    cudaStream_t stream, Empty empty = Empty()) {
  combine_kernel<TQ, HD, Empty><<<a.B * a.K * a.Sx * a.G,
                                  HD / 2 > 32 ? HD / 2 : 32,
                                  2 * sizeof(float) * splits, stream>>>(
      part, a, splits, empty);
  return cudaGetLastError();
}

}  // namespace paged

// Readable name of a CUDA error code returned by a launch function.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
