// Backward of the Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the TPU kernel src/repro/kernels/mamba_scan.py
// has no backward.  The reference trains through the XLA scan that its
// mamba layers run, src/repro/models/mamba.py _selective_scan, and JAX
// differentiates it.
//
//   dt, x, Bm, Cm, A, Dsk   as in mamba_scan.cu (x float or bf16)
//   states   [B, tiles, D, N] float   the state before every kTile-step
//            tile (tiles = ceil(S / kTile); entry 0 is h0), as the forward
//            kernel mamba_scan.cu writes it under training (mamba_tile.cuh)
//   dy       [B, S, D] float    gradient of y
//   dh_last  [B, D, N] float    gradient of the state after token S - 1
//   d_dt [B, S, D] float, dx [B, S, D] (x's type), dBm, dCm [B, S, N]
//   float, dA [D, N] float, dDsk [D] float, dh0 [B, D, N] float   out
//   part [B, S, blocks, 2, N], part_a [B, D, N], part_d [B, D]   float
//   scratch
//
// With a_t = exp(dt_t A) and g_t = dL/dh_t = dy_t C_t + a_{t+1} g_{t+1}
// (g_{S-1} = dy_{S-1} C_{S-1} + dh_last):
//   dC_t[n] = sum_d dy_t[d] h_t[d, n]       dB_t[n] = sum_d g_t dt_t x_t
//   dx_t = dt_t sum_n g_t B_t + Dsk dy_t    d_dt_t = sum_n g_t (A a_t h_{t-1}
//   dA = sum_{b,t} g_t dt_t a_t h_{t-1}                        + x_t B_t)
//   dDsk = sum_{b,t} dy_t x_t               dh0 = a_0 g_0
//
// What bounds it on the H100: at falcon-mamba-7b's training shape (B 8,
// S 256, D 8192, N 16, bf16 x) the call must read dt, dy (fp32) and x
// (bf16) and write d_dt (fp32) and dx (bf16): about 283 MB with the small
// operands, 84 us at 3.35 TB/s.  Each pass over the sequence takes
// B * S * D * N = 268 M exponentials, 64 us at the SFU's rate, and the walk
// back does about a dozen float32 operations for each of them and sums
// over both the states (d_dt, dx) and the channels (dB, dC) at every step.
// The work a step is sequential in t for a channel and its sums cross
// lanes, so what binds is the schedulers' instruction rate and the
// shared-memory and shuffle traffic of those sums
// (scripts/scan_bwd_variants.py takes each part out in turn: PERF.md), not
// the bytes.
//
// What the design does about it:
// * the forward keeps the state at every tile boundary (mamba_scan.cu's
//   `states`, 67 MB at the training shape), so nothing reruns the forward
//   from h0: each tile's kTile states are recomputed from its boundary into
//   registers (the one exponential pass besides the walk), and the walk
//   back takes a_t = ex2(dt_t A log2 e) once more, as the forward does, so
//   both see the same a_t (keeping the tile's a_t in registers instead
//   needs more registers, so fewer warps an SM, and is slower:
//   scripts/scan_bwd_variants.py's keep-a).  a_t h_{t-1} is
//   h_t - dt_t x_t B_t: no state before the tile is kept and no
//   exponential is needed for it.  A pad lane (dt = 0) has a = 1 exactly
//   and passes g through;
// * a channel's N states lie over N / 4 lanes, a float4 each, so a warp
//   holds 32 / (N / 4) channels (8 at N 16) and a lane the 4 x kTile
//   states of a tile in 64 registers;
// * the sums over channels (dB_t and dC_t) are one butterfly
//   reduce-scatter of __shfl_xor_sync over the warp's channel bits with
//   few selects (channel_sums: a lane whose channel has bit 0 set holds
//   its two pairs of states swapped, which its B and C loads do for free),
//   7 shuffles a step that leave one value a lane; the warps' values are
//   added in warp order in shared memory once a tile and written as
//   float32 partials a block, and a second kernel adds the blocks' in
//   block order, and dA's and dDsk's (summed over the sequence in
//   registers) in sequence order: no atomics, and a second call gives the
//   same bits;
// * the sums over a channel's states (d_dt, dx) leave the walk: each lane
//   writes its two parts a step to shared memory, and the block adds the
//   channel's lanes as a pairwise tree when it stores the tile's rows;
// * each step's operands are loaded before the step after it stores, so
//   that the loads need not wait for the stores and two steps overlap;
// * a tile's dt, x, dy, Bm, Cm and boundary states land in shared memory
//   by cp.async while the tile after it is walked (two stages; a width
//   that is not a multiple of 8 stages dt, x and dy through registers).
// Blocks: B * ceil(D / 128) (512 at falcon's shape) of 32 N threads, held
// to 128 registers a thread so that at N 16 one block of 512 fills an
// SM's register file (16 warps, four a scheduler); 164 KB of shared
// memory at N 16.  Traffic beyond the bound: the states (67 MB read), the
// block partials (16.8 MB written and read) and dA's (4.2 MB written and
// read).  What holds it back now: about 100 instructions a step of a
// lane's four states, 7 shuffles and 13 shared-memory accesses among them,
// at four warps a scheduler (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mamba_tile.cuh"

namespace {

// steps between kept states (mamba_tile.cuh), recomputed at once
constexpr int kTile = mamba::kStateTile;
constexpr int kChannels = 128;  // d channels of a block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kAll = 0xffffffffu;

template <int N>
struct Geometry {
  static constexpr int kLanes = N / 4;                   // lanes a channel
  static constexpr int kWarpChannels = 32 / kLanes;      // channels a warp
  static constexpr int kWarps = kChannels / kWarpChannels;
  static constexpr int kThreads = 32 * kWarps;           // threads a block
  // blocks an SM at 128 registers a thread
  static constexpr int kMinBlocks = 512 / kThreads;
  static constexpr int kLaneBits = N == 16 ? 2 : N == 8 ? 1 : 0;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// component i of a float4 (i a constant once the loops are unrolled)
__device__ __forceinline__ float& at(float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One stage: a tile's inputs, and the state before it.
template <typename TX, int N>
struct Stage {
  float4 h[kChannels * N / 4];  // [channel][N]: the state before the tile
  float dt[kTile][kChannels];
  float dy[kTile][kChannels];
  TX x[kTile][kChannels];
  float b[kTile][N];
  float c[kTile][N];
};

template <typename TX, int N>
struct Smem {
  Stage<TX, N> stage[2];
  float part[Geometry<N>::kWarps][kTile][2 * N];  // the warps' dB, dC
  // each lane's (sa + x sb, sb) of a step: d_dt and dx are their sums over
  // the channel's lanes
  float2 lanes[kTile][kChannels][Geometry<N>::kLanes];
};

// A lane's float4 of states in its order: the two pairs swapped when its
// channel's bit 0 (c0, channel_sums) is set.
__device__ __forceinline__ float4 in_order(float4 v, int c0) {
  return c0 ? make_float4(v.z, v.w, v.x, v.y) : v;
}

// Row tt of B or C at the lane's states in its order: two 8-byte loads at
// the lane's own pair offsets, so that a warp's load reads only the row.
template <int N>
__device__ __forceinline__ float4 row_in_order(const float (&row)[N], int j,
                                               int c0) {
  const float2* pairs = reinterpret_cast<const float2*>(row) + 2 * j;
  const float2 lo = pairs[c0], hi = pairs[c0 ^ 1];
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// A step's operands of a lane's channel, and B and C in its order.
struct Step {
  float dt, x, dy;
  float4 b, c;
};

template <typename TX, int N>
__device__ __forceinline__ Step load_step(const Stage<TX, N>& st, int tt,
                                          int c, int j, int c0) {
  return {st.dt[tt][c], to_float(st.x[tt][c]), st.dy[tt][c],
          row_in_order(st.b[tt], j, c0), row_in_order(st.c[tt], j, c0)};
}

// Rows [0, kTile) of a [B, S, W] array from row0 = b * S + t0, columns
// [w0, w0 + kCols), into dst by 16-byte cp.async chunks; rows at or past
// nt and columns at or past W are zero-filled (W a multiple of the chunk).
template <typename T, int kCols, int kThreads>
__device__ __forceinline__ void stage_rows(T (*dst)[kCols],
                                           const T* __restrict__ src,
                                           size_t row0, int nt, int W,
                                           int w0) {
  constexpr int kPer = 16 / sizeof(T);  // elements a chunk
  constexpr int kRow = kCols / kPer;    // chunks a row
  constexpr int kChunks = kTile * kRow;
#pragma unroll
  for (int r = 0; r < (kChunks + kThreads - 1) / kThreads; ++r) {
    const int q = threadIdx.x + r * kThreads;
    if (kChunks % kThreads == 0 || q < kChunks) {
      const int t = q / kRow, col = (q % kRow) * kPer;
      const bool full = t < nt && w0 + col < W;
      cp_async16(&dst[t][col], full ? src + (row0 + t) * W + w0 + col : src,
                 full);
    }
  }
}

// The same through registers, for a width that is not a multiple of 8.
template <typename T, int kCols, int kThreads>
__device__ __forceinline__ void load_rows(T (*dst)[kCols],
                                          const T* __restrict__ src,
                                          size_t row0, int nt, int W,
                                          int w0) {
  for (int i = threadIdx.x; i < kTile * kCols; i += kThreads) {
    const int t = i / kCols, col = i % kCols;
    dst[t][col] = t < nt && w0 + col < W ? src[(row0 + t) * W + w0 + col]
                                         : T(0.f);
  }
}

// Start the copies of tile `tile`'s inputs and boundary into `st`, one
// cp.async group.
template <typename TX, int N>
__device__ __forceinline__ void stage_tile(
    Stage<TX, N>& st, const float* __restrict__ dt,
    const TX* __restrict__ x, const float* __restrict__ dy,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ states, int b, int tile, int tiles, int S,
    int D, int d0, bool async) {
  constexpr int kThreads = Geometry<N>::kThreads;
  const int t0 = tile * kTile, nt = min(kTile, S - t0);
  const size_t row0 = static_cast<size_t>(b) * S + t0;
  if (async) {
    stage_rows<float, kChannels, kThreads>(st.dt, dt, row0, nt, D, d0);
    stage_rows<float, kChannels, kThreads>(st.dy, dy, row0, nt, D, d0);
    stage_rows<TX, kChannels, kThreads>(st.x, x, row0, nt, D, d0);
  } else {
    load_rows<float, kChannels, kThreads>(st.dt, dt, row0, nt, D, d0);
    load_rows<float, kChannels, kThreads>(st.dy, dy, row0, nt, D, d0);
    load_rows<TX, kChannels, kThreads>(st.x, x, row0, nt, D, d0);
  }
  stage_rows<float, N, kThreads>(st.b, Bm, row0, nt, N, 0);
  stage_rows<float, N, kThreads>(st.c, Cm, row0, nt, N, 0);
  // the boundary: the block's channels of one [D, N] row, contiguous
  constexpr int kChunks = kChannels * N / 4;
  const float* row = states + ((static_cast<size_t>(b) * tiles + tile) * D
                               + d0) * N;
#pragma unroll
  for (int r = 0; r < (kChunks + kThreads - 1) / kThreads; ++r) {
    const int q = threadIdx.x + r * kThreads;
    if (kChunks % kThreads == 0 || q < kChunks) {
      const bool full = d0 + q * 4 / N < D;
      cp_async16(&st.h[q], full ? row + 4 * q : states, full);
    }
  }
  cp_async_commit();
}

// Sums over the warp's channels of dtx_c g_c[n] (dB) and dy_c h_c[n] (dC)
// for one of the lane's states n.  A channel c's lane holds its states
// 4 j .. 4 j + 3 with the two pairs swapped when c0 is set (c0, c1, c2:
// bits 0-2 of c within the warp, lane bits kLanes, 2 kLanes, 4 kLanes), so
// the partner across c0 holds in places 2 and 3 the states this lane holds
// in places 0 and 1: the first step of the butterfly reduce-scatter needs
// no selects, and its products are fused into its adds.  The second keeps
// place c1, the third keeps dB (c2 clear) or dC (c2 set), and (N < 16) the
// rest add over the higher bits.  The lane ends with dB or dC of its state
// 4 j + 2 c0 + c1, each channel pair (c, c ^ 1) added as (c, c ^ 2), then
// (c, c ^ 4) and up, the same bits in every lane that holds it.
template <int kLanes>
__device__ __forceinline__ float channel_sums(float dtx, float4 g, float dy,
                                              float4 h, int lane) {
  const float db0 = fmaf(g.x, dtx, __shfl_xor_sync(kAll, g.z * dtx, kLanes));
  const float db1 = fmaf(g.y, dtx, __shfl_xor_sync(kAll, g.w * dtx, kLanes));
  const float dc0 = fmaf(h.x, dy, __shfl_xor_sync(kAll, h.z * dy, kLanes));
  const float dc1 = fmaf(h.y, dy, __shfl_xor_sync(kAll, h.w * dy, kLanes));
  bool up = lane & (2 * kLanes);
  const float bs = (up ? db1 : db0)
                   + __shfl_xor_sync(kAll, up ? db0 : db1, 2 * kLanes);
  const float cs = (up ? dc1 : dc0)
                   + __shfl_xor_sync(kAll, up ? dc0 : dc1, 2 * kLanes);
  up = lane & (4 * kLanes);
  float r = (up ? cs : bs) + __shfl_xor_sync(kAll, up ? bs : cs, 4 * kLanes);
#pragma unroll
  for (int m = 8 * kLanes; m < 32; m *= 2) r += __shfl_xor_sync(kAll, r, m);
  return r;
}

template <typename TX, int N>
__global__ void __launch_bounds__(Geometry<N>::kThreads,
                                  Geometry<N>::kMinBlocks)
    mamba_scan_bwd_kernel(const float* __restrict__ dt,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const TX* __restrict__ x,
                          const float* __restrict__ A,
                          const float* __restrict__ Dsk,
                          const float* __restrict__ states,
                          const float* __restrict__ dy,
                          const float* __restrict__ dh_last,
                          float* __restrict__ d_dt, TX* __restrict__ dx,
                          float* __restrict__ dh0,
                          float* __restrict__ part,
                          float* __restrict__ part_a,
                          float* __restrict__ part_d, int S, int D,
                          bool async) {
  using G = Geometry<N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<TX, N>& sm = *reinterpret_cast<Smem<TX, N>*>(smem_raw);
  const int b = blockIdx.y;
  const int blocks = gridDim.x;
  const int d0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cw = lane / G::kLanes;              // channel within the warp
  const int j = lane % G::kLanes;               // the lane's float4 of states
  const int c = warp * G::kWarpChannels + cw;   // channel within the block
  const int d = d0 + c;
  const bool live = d < D;
  const int tiles = (S + kTile - 1) / kTile;
  // the lane's order of its states (channel_sums), the warp sum it ends
  // with, dB or dC of state 4 j + 2 c0 + c1, and whether it writes it (no
  // channel bit above c2 set)
  const int c0 = cw & 1;
  const int slot = ((cw >> 2) & 1) * N + 4 * j + 2 * c0 + ((cw >> 1) & 1);
  const bool writer = (lane >> (G::kLaneBits + 3)) == 0;

  float4 a2 = make_float4(0.f, 0.f, 0.f, 0.f), carry = a2, dacc = a2;
  float dd = 0.f;  // sum over t of dy x (the skip's gradient)
  if (live) {
    const size_t dn = static_cast<size_t>(d) * N + 4 * j;
    const float4 av = in_order(*reinterpret_cast<const float4*>(A + dn), c0);
    a2 = make_float4(av.x * kLog2e, av.y * kLog2e, av.z * kLog2e,
                     av.w * kLog2e);
    carry = in_order(*reinterpret_cast<const float4*>(
        dh_last + static_cast<size_t>(b) * D * N + dn), c0);
  }

  stage_tile<TX, N>(sm.stage[(tiles - 1) & 1], dt, x, dy, Bm, Cm, states, b,
                    tiles - 1, tiles, S, D, d0, async);
  cp_async_wait_all();
  for (int tile = tiles - 1; tile >= 0; --tile) {
    Stage<TX, N>& st = sm.stage[tile & 1];
    const int t0 = tile * kTile, nt = min(kTile, S - t0);
    __syncthreads();  // this tile has landed; the other stage is stored
    if (tile > 0) {
      stage_tile<TX, N>(sm.stage[(tile - 1) & 1], dt, x, dy, Bm, Cm, states,
                        b, tile - 1, tiles, S, D, d0, async);
    }

    // the tile's states h_t, recomputed from its boundary as the forward
    // computed them (rows past nt are zero: a = 1, the state unchanged)
    float4 hs[kTile];
    float4 h = in_order(st.h[c * G::kLanes + j], c0);
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) {
      const float dtv = st.dt[tt][c];
      const float dtx = dtv * to_float(st.x[tt][c]);
      const float4 bq = row_in_order(st.b[tt], j, c0);
      const float4 a = make_float4(ex2(dtv * a2.x), ex2(dtv * a2.y),
                                   ex2(dtv * a2.z), ex2(dtv * a2.w));
      h.x = fmaf(a.x, h.x, dtx * bq.x);
      h.y = fmaf(a.y, h.y, dtx * bq.y);
      h.z = fmaf(a.z, h.z, dtx * bq.z);
      h.w = fmaf(a.w, h.w, dtx * bq.w);
      hs[tt] = h;
    }

    // g walked back through the tile, with dB_t = sum_d g_t dt_t x_t and
    // dC_t = sum_d dy_t h_t over the warp's channels.  Each step's
    // operands are loaded before the step after it stores its results, so
    // that the loads need not wait for those stores.
    Step cur = load_step(st, kTile - 1, c, j, c0);
#pragma unroll
    for (int tt = kTile - 1; tt >= 0; --tt) {
      const Step next = load_step(st, tt > 0 ? tt - 1 : 0, c, j, c0);
      const float dtv = cur.dt, xv = cur.x, dyv = cur.dy, dtx = dtv * xv;
      float4 g;
      // sums over the lane's states of A log2(e) a h_{t-1} g (A log2 e:
      // the exponent's scale, kept in place of A) and of g B
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = ex2(dtv * at(a2, i));
        at(g, i) = fmaf(dyv, at(cur.c, i), at(carry, i));
        // g a_t h_{t-1} = g (h_t - dt_t x_t B_t)
        const float u = at(g, i) * fmaf(-dtx, at(cur.b, i), at(hs[tt], i));
        sa = fmaf(at(a2, i), u, sa);
        sb = fmaf(at(g, i), at(cur.b, i), sb);
        at(dacc, i) = fmaf(dtv, u, at(dacc, i));
        at(carry, i) = a * at(g, i);
      }
      // d_dt = sum over the channel's lanes of (sa + x sb), dx = dt sum(sb)
      // + Dsk dy: added once the tile is walked
      sm.lanes[tt][c][j] = make_float2(fmaf(xv, sb, sa * kLn2), sb);
      const float sum = channel_sums<G::kLanes>(dtx, g, dyv, hs[tt], lane);
      if (writer) sm.part[warp][tt][slot] = sum;
      dd = fmaf(dyv, xv, dd);
      cur = next;
    }
    cp_async_wait_all();  // the next tile's inputs, this thread's copies
    __syncthreads();      // everyone's, and the walk's results

    // dB and dC of the tile: the warps' sums added in warp order
    for (int o = tid; o < kTile * 2 * N; o += G::kThreads) {
      const int tt = o / (2 * N), qn = o % (2 * N);
      float s = sm.part[0][tt][qn];
#pragma unroll
      for (int w = 1; w < G::kWarps; ++w) s += sm.part[w][tt][qn];
      if (tt < nt) {
        part[((static_cast<size_t>(b) * S + t0 + tt) * blocks + blockIdx.x)
                 * 2 * N + qn] = s;
      }
    }
    // d_dt and dx of the tile: the lanes' parts added as a pairwise tree
    for (int i = tid; i < kTile * kChannels; i += G::kThreads) {
      const int t = i / kChannels, cc = i % kChannels;
      if (t < nt && d0 + cc < D) {
        float2 s[G::kLanes];
#pragma unroll
        for (int k = 0; k < G::kLanes; ++k) s[k] = sm.lanes[t][cc][k];
#pragma unroll
        for (int w = 1; w < G::kLanes; w *= 2) {
#pragma unroll
          for (int k = 0; k < G::kLanes; k += 2 * w) {
            s[k] = make_float2(s[k].x + s[k + w].x, s[k].y + s[k + w].y);
          }
        }
        const size_t off = (static_cast<size_t>(b) * S + t0 + t) * D + d0
                           + cc;
        d_dt[off] = s[0].x;
        dx[off] = from_float<TX>(fmaf(st.dt[t][cc], s[0].y,
                                      Dsk[d0 + cc] * st.dy[t][cc]));
      }
    }
  }

  if (live) {
    const size_t bdn = (static_cast<size_t>(b) * D + d) * N + 4 * j;
    *reinterpret_cast<float4*>(dh0 + bdn) = in_order(carry, c0);
    *reinterpret_cast<float4*>(part_a + bdn) = in_order(dacc, c0);
    if (j == 0) part_d[static_cast<size_t>(b) * D + d] = dd;
  }
}

// The second pass: every partial added in a fixed order.  Outputs, one a
// thread: dBm and dCm [B, S, N] over the channel blocks, then dA [D, N]
// and dDsk [D] over the sequences.
__global__ void __launch_bounds__(256)
    mamba_scan_bwd_sum(const float* __restrict__ part,
                       const float* __restrict__ part_a,
                       const float* __restrict__ part_d,
                       float* __restrict__ dBm, float* __restrict__ dCm,
                       float* __restrict__ dA, float* __restrict__ dDsk,
                       int B, int S, int D, int N, int blocks) {
  const size_t bsn = static_cast<size_t>(B) * S * N;
  const size_t dn = static_cast<size_t>(D) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < 2 * bsn) {
    const int q = i >= bsn;  // 0: dB, 1: dC
    const size_t r = i - q * bsn, bt = r / N;
    const int n = r % N;
    const float* p = part + bt * blocks * 2 * N + q * N + n;
    float s = 0.f;
    for (int blk = 0; blk < blocks; ++blk) s += p[static_cast<size_t>(blk)
                                                  * 2 * N];
    (q ? dCm : dBm)[r] = s;
  } else if (i < 2 * bsn + dn) {
    const size_t r = i - 2 * bsn;
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += part_a[b * dn + r];
    dA[r] = s;
  } else if (i < 2 * bsn + dn + D) {
    const size_t r = i - 2 * bsn - dn;
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += part_d[static_cast<size_t>(b) * D + r];
    dDsk[r] = s;
  }
}

template <typename TX, int N>
cudaError_t launch(const void* const* in, void* const* out, void* const* tmp,
                   int B, int S, int D, cudaStream_t stream) {
  using G = Geometry<N>;
  constexpr size_t kSmem = sizeof(Smem<TX, N>);
  auto kernel = mamba_scan_bwd_kernel<TX, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const int blocks = (D + kChannels - 1) / kChannels;
  const bool async = D % 8 == 0;  // rows of dt, x, dy in whole 16-byte chunks
  kernel<<<dim3(blocks, B), G::kThreads, kSmem, stream>>>(
      static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
      static_cast<const float*>(in[2]), static_cast<const TX*>(in[3]),
      static_cast<const float*>(in[4]), static_cast<const float*>(in[5]),
      static_cast<const float*>(in[6]), static_cast<const float*>(in[7]),
      static_cast<const float*>(in[8]), static_cast<float*>(out[0]),
      static_cast<TX*>(out[3]), static_cast<float*>(out[6]),
      static_cast<float*>(tmp[0]), static_cast<float*>(tmp[1]),
      static_cast<float*>(tmp[2]), S, D, async);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = 2 * static_cast<size_t>(B) * S * N
                       + static_cast<size_t>(D) * N + D;
  mamba_scan_bwd_sum<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                       stream>>>(
      static_cast<const float*>(tmp[0]), static_cast<const float*>(tmp[1]),
      static_cast<const float*>(tmp[2]), static_cast<float*>(out[1]),
      static_cast<float*>(out[2]), static_cast<float*>(out[4]),
      static_cast<float*>(out[5]), B, S, D, N, blocks);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t by_state(const void* const* in, void* const* out,
                     void* const* tmp, int B, int S, int D, int N,
                     cudaStream_t stream) {
  switch (N) {
    case 4: return launch<TX, 4>(in, out, tmp, B, S, D, stream);
    case 8: return launch<TX, 8>(in, out, tmp, B, S, D, stream);
    case 16: return launch<TX, 16>(in, out, tmp, B, S, D, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x_dtype: 0 = float x and dx, 1 = bf16 (every other operand is float).
// Returns the cudaError_t of the launches (0 = success).
extern "C" int mamba_scan_bwd(int x_dtype, const void* dt, const void* Bm,
                              const void* Cm, const void* x, const void* A,
                              const void* Dsk, const void* states,
                              const void* dy, const void* dh_last,
                              void* d_dt, void* dBm, void* dCm, void* dx,
                              void* dA, void* dDsk, void* dh0, void* part,
                              void* part_a, void* part_d, int B, int S,
                              int D, int N, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return cudaErrorInvalidValue;
  const void* in[] = {dt, Bm, Cm, x, A, Dsk, states, dy, dh_last};
  void* out[] = {d_dt, dBm, dCm, dx, dA, dDsk, dh0};
  void* tmp[] = {part, part_a, part_d};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: return by_state<float>(in, out, tmp, B, S, D, N, st);
    case 1: return by_state<__nv_bfloat16>(in, out, tmp, B, S, D, N, st);
    default: return cudaErrorInvalidValue;
  }
}

// Readable name of a CUDA error code returned by a launch function.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
