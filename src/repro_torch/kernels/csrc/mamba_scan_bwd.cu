// Backward of the Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the TPU kernel src/repro/kernels/mamba_scan.py
// has no backward.  The reference trains through the XLA scan that its
// mamba layers run, src/repro/models/mamba.py _selective_scan, and JAX
// differentiates it.
//
//   dt, x, Bm, Cm, A, Dsk, h0   as in mamba_scan.cu (x float or bf16)
//   dy       [B, S, D] float    gradient of y
//   dh_last  [B, D, N] float    gradient of the state after token S - 1
//   d_dt [B, S, D] float, dx [B, S, D] (x's type), dBm, dCm [B, S, N]
//   float, dA [D, N] float, dDsk [D] float, dh0 [B, D, N] float   out
//   states [B, tiles, D, N], part [B, S, blocks, 2, N], part_a [B, D, N],
//   part_d [B, D]  float scratch
//
// With a_t = exp(dt_t A) and g_t = dL/dh_t = dy_t C_t + a_{t+1} g_{t+1}
// (g_{S-1} = dy_{S-1} C_{S-1} + dh_last):
//   dC_t[n] = sum_d dy_t[d] h_t[d, n]       dB_t[n] = sum_d g_t dt_t x_t
//   dx_t = dt_t sum_n g_t B_t + Dsk dy_t    d_dt_t = sum_n g_t (A a_t h_{t-1}
//   dA = sum_{b,t} g_t dt_t a_t h_{t-1}                        + x_t B_t)
//   dDsk = sum_{b,t} dy_t x_t               dh0 = a_0 g_0
//
// What bounds it on the H100: at falcon-mamba-7b's training shape (B 8,
// S 256, D 8192, N 16, bf16 x) the call must read dt, dy (fp32), x (bf16)
// and write d_dt (fp32) and dx (bf16): about 268 MB, 80 us at 3.35 TB/s.
// It also needs B * S * D * N = 268 M exponentials a pass over the
// sequence, 64 us at the SFU's rate; this kernel makes three passes.
//
// What the design does about it:
// * the forward's layout: a block of kChannels channels of one sequence, a
//   channel's N states over kLanes lanes (two at N 8 and 16, one at N 4)
//   in whole float4 groups, time sequential in each lane;
// * the states are not saved by the forward (1.07 GB a layer at the
//   training shape): a first pass runs the forward from h0 and writes the
//   state at each kTile-step tile boundary to `states`; then the tiles are
//   walked in reverse, each one's kTile + 1 states recomputed into shared
//   memory from its boundary before g runs backward through it.  exp(dt A)
//   is ex2.approx of dt * (A log2 e), as in the forward, so both see the
//   same a_t; a pad lane (dt = 0) has a = 1 exactly and passes g through;
// * per-channel sums over n (dx, d_dt) add each lane's states and the two
//   lanes' sums with one __shfl_xor_sync; the even lane puts them in
//   place of the step's dt and x in shared memory, and the block stores
//   each tile's d_dt and dx coalesced;
// * sums across channels (dC_t, and dB_t from g_t dt_t x_t, which the walk
//   writes over the state it no longer needs) are added over the block's
//   channels in shared memory after each tile, in channel order, and
//   written as float32 partials a block; dA and dDsk are summed over the
//   sequence in registers and written as partials a sequence.  A second
//   kernel adds the partials in a fixed order: no atomics, so a second call
//   gives the same bits.
// Blocks: B * ceil(D / 64) (1024 at falcon's shape), 85 KB of shared memory
// at N 16 (two blocks an SM).  What holds it back: three passes of
// exponentials, the state round trip through shared memory, and the
// serial reductions over 64 channels after each tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 64;  // d channels of a block
constexpr int kTile = 16;      // steps recomputed and kept at once
constexpr float kLog2e = 1.4426950408889634f;

template <int N>
struct Geometry {
  static constexpr int kLanes = N == 4 ? 1 : 2;        // lanes a channel
  static constexpr int kGroups = N / 4 / kLanes;       // float4s a lane
  static constexpr int kThreads = kChannels * kLanes;  // threads a block
  // float4s a row of the state buffer, one row per (step, group): padded
  // so that the reductions over channels, whose threads read one state
  // each of neighbouring rows, hit distinct banks
  static constexpr int kRow = kThreads + 2;
  static constexpr int kRows = (kTile + 1) * kGroups;
  static constexpr size_t kSmem =
      sizeof(float4) * kRows * kRow + sizeof(float) * kTile
      * (3 * kChannels + 2 * N);
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
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The shared-memory buffers of a block.
template <int N>
struct Smem {
  float4* hs;                // [kRows][kRow]: states, then g dt x
  float (*dt_s)[kChannels];  // [kTile]: dt, then d_dt
  float (*x_s)[kChannels];   // [kTile]: x, then dx
  float (*dy_s)[kChannels];  // [kTile]
  float (*b_s)[N];           // [kTile]
  float (*c_s)[N];           // [kTile]

  __device__ explicit Smem(unsigned char* raw) {
    using G = Geometry<N>;
    hs = reinterpret_cast<float4*>(raw);
    float* f = reinterpret_cast<float*>(hs + G::kRows * G::kRow);
    dt_s = reinterpret_cast<float (*)[kChannels]>(f);
    x_s = dt_s + kTile;
    dy_s = x_s + kTile;
    b_s = reinterpret_cast<float (*)[N]>(dy_s + kTile);
    c_s = b_s + kTile;
  }
  // the float4 of states of thread `tid`, group k, at tile step `step`
  // (step 0: the state before the tile)
  __device__ float4& state(int step, int k, int tid) {
    return hs[(step * Geometry<N>::kGroups + k) * Geometry<N>::kRow + tid];
  }
  // state n of channel cc at tile step `step`
  __device__ float state_n(int step, int cc, int n) {
    using G = Geometry<N>;
    const int g = n / 4;
    return reinterpret_cast<const float*>(
        &state(step, g / G::kLanes, cc * G::kLanes + g % G::kLanes))[n % 4];
  }
};

// Rows [t0, t0 + nt) of a tile into shared memory (float), zero past nt
// and past D: dt, x and Bm, and with `full` also dy and Cm.  Every load of
// a thread is issued before the first store, so that a tile's loads are in
// flight together.
template <typename TX, int N, bool full>
__device__ __forceinline__ void stage(Smem<N>& sm, const float* dt,
                                      const TX* x, const float* dy,
                                      const float* Bm, const float* Cm,
                                      int b, int t0, int nt, int S, int D,
                                      int d0) {
  constexpr int kThreads = Geometry<N>::kThreads;
  constexpr int kPer = kTile * kChannels / kThreads;  // (t, c) a thread
  constexpr int kPerN = kTile * N / kThreads;         // (t, n) a thread
  static_assert(kTile * kChannels % kThreads == 0 && kTile * N % kThreads == 0,
                "a tile splits evenly over the block");
  float rdt[kPer], rx[kPer], rdy[kPer], rb[kPerN], rc[kPerN];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = threadIdx.x + r * kThreads;
    const int t = i / kChannels, cc = i % kChannels;
    const bool in = t < nt && d0 + cc < D;
    const size_t off = (static_cast<size_t>(b) * S + t0 + t) * D + d0 + cc;
    rdt[r] = in ? dt[off] : 0.f;
    rx[r] = in ? to_float(x[off]) : 0.f;
    rdy[r] = full && in ? dy[off] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kPerN; ++r) {
    const int i = threadIdx.x + r * kThreads;
    const size_t src = (static_cast<size_t>(b) * S + t0) * N + i;
    rb[r] = i / N < nt ? Bm[src] : 0.f;
    rc[r] = full && i / N < nt ? Cm[src] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = threadIdx.x + r * kThreads;
    const int t = i / kChannels, cc = i % kChannels;
    sm.dt_s[t][cc] = rdt[r];
    sm.x_s[t][cc] = rx[r];
    if (full) sm.dy_s[t][cc] = rdy[r];
  }
#pragma unroll
  for (int r = 0; r < kPerN; ++r) {
    const int i = threadIdx.x + r * kThreads;
    sm.b_s[i / N][i % N] = rb[r];
    if (full) sm.c_s[i / N][i % N] = rc[r];
  }
}

// One forward step of a lane's states (as mamba_scan.cu's step).
template <int N>
__device__ __forceinline__ void advance(float4 (&h)[Geometry<N>::kGroups],
                                        const float4 (&a2)[Geometry<N>::kGroups],
                                        float dtv, float xv,
                                        const float* b_row, int j) {
  using G = Geometry<N>;
  const float dx = dtv * xv;
#pragma unroll
  for (int k = 0; k < G::kGroups; ++k) {
    const float4 bq = reinterpret_cast<const float4*>(b_row)[j + G::kLanes * k];
    h[k].x = fmaf(ex2(dtv * a2[k].x), h[k].x, dx * bq.x);
    h[k].y = fmaf(ex2(dtv * a2[k].y), h[k].y, dx * bq.y);
    h[k].z = fmaf(ex2(dtv * a2[k].z), h[k].z, dx * bq.z);
    h[k].w = fmaf(ex2(dtv * a2[k].w), h[k].w, dx * bq.w);
  }
}

// Sum over the block's channels, in channel order, of each (step, state)
// of the tile: with `weigh`, dy_t[c] * h_t[c, n] (dC), else the g dt x the
// walk left in the state buffer (dB); written to part[b, t, blk, q, n].
template <int N, bool weigh>
__device__ __forceinline__ void channel_sums(Smem<N>& sm,
                                             float* __restrict__ part, int b,
                                             int t0, int nt, int S,
                                             int blocks, int q) {
  constexpr int kThreads = Geometry<N>::kThreads;
  for (int o = threadIdx.x; o < nt * N; o += kThreads) {
    const int tt = o / N, n = o % N;
    float s = 0.f;
    for (int cc = 0; cc < kChannels; ++cc) {
      const float v = sm.state_n(tt + 1, cc, n);
      s = weigh ? fmaf(sm.dy_s[tt][cc], v, s) : s + v;
    }
    part[((static_cast<size_t>(b) * S + t0 + tt) * blocks + blockIdx.x) * 2
             * N + q * N + n] = s;
  }
}

template <typename TX, int N>
__global__ void __launch_bounds__(Geometry<N>::kThreads)
    mamba_scan_bwd_kernel(const float* __restrict__ dt,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const TX* __restrict__ x,
                          const float* __restrict__ A,
                          const float* __restrict__ Dsk,
                          const float* __restrict__ h0,
                          const float* __restrict__ dy,
                          const float* __restrict__ dh_last,
                          float* __restrict__ d_dt, TX* __restrict__ dx,
                          float* __restrict__ dh0,
                          float* __restrict__ states,
                          float* __restrict__ part,
                          float* __restrict__ part_a,
                          float* __restrict__ part_d, int S, int D) {
  using G = Geometry<N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<N> sm(smem_raw);
  const int b = blockIdx.y;
  const int blocks = gridDim.x;
  const int d0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x;
  const int c = tid / G::kLanes;  // channel within the block
  const int j = tid % G::kLanes;  // lane within the channel
  const int d = d0 + c;
  const bool live = d < D;
  const int tiles = (S + kTile - 1) / kTile;
  // offset of this lane's group k in a [.., D, N] array at (row, d)
  auto at_dn = [&](size_t row, int k) {
    return (row * D + d) * N + 4 * (j + G::kLanes * k);
  };

  float4 h[G::kGroups], a2[G::kGroups], av[G::kGroups];
  float dsk = 0.f;
#pragma unroll
  for (int k = 0; k < G::kGroups; ++k) {
    h[k] = a2[k] = av[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < G::kGroups; ++k) {
      h[k] = *reinterpret_cast<const float4*>(h0 + at_dn(b, k));
      av[k] = *reinterpret_cast<const float4*>(A + at_dn(0, k));
      a2[k] = make_float4(av[k].x * kLog2e, av[k].y * kLog2e,
                          av[k].z * kLog2e, av[k].w * kLog2e);
    }
    dsk = Dsk[d];
  }

  // pass 1: the forward from h0, keeping the state before every tile
  for (int tile = 0; tile < tiles; ++tile) {
    if (live) {
#pragma unroll
      for (int k = 0; k < G::kGroups; ++k) {
        *reinterpret_cast<float4*>(
            states + at_dn(static_cast<size_t>(b) * tiles + tile, k)) = h[k];
      }
    }
    if (tile == tiles - 1) break;
    __syncthreads();  // the previous tile's inputs have been consumed
    stage<TX, N, false>(sm, dt, x, dy, Bm, Cm, b, tile * kTile, kTile, S, D,
                        d0);
    __syncthreads();
    for (int tt = 0; tt < kTile; ++tt) {
      advance<N>(h, a2, sm.dt_s[tt][c], sm.x_s[tt][c], sm.b_s[tt], j);
    }
  }

  // pass 2: the tiles in reverse, g carried backwards through each
  float4 carry[G::kGroups], dacc[G::kGroups];
#pragma unroll
  for (int k = 0; k < G::kGroups; ++k) {
    carry[k] = dacc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      carry[k] = *reinterpret_cast<const float4*>(dh_last + at_dn(b, k));
    }
  }
  float dd = 0.f;  // sum over t of dy x (the skip's gradient)
  for (int tile = tiles - 1; tile >= 0; --tile) {
    const int t0 = tile * kTile, nt = min(kTile, S - t0);
    if (live) {
#pragma unroll
      for (int k = 0; k < G::kGroups; ++k) {
        h[k] = *reinterpret_cast<const float4*>(
            states + at_dn(static_cast<size_t>(b) * tiles + tile, k));
      }
    }
    __syncthreads();  // the previous tile's shared memory has been read
    stage<TX, N, true>(sm, dt, x, dy, Bm, Cm, b, t0, nt, S, D, d0);
#pragma unroll
    for (int k = 0; k < G::kGroups; ++k) sm.state(0, k, tid) = h[k];
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {  // the tile's states, recomputed
      advance<N>(h, a2, sm.dt_s[tt][c], sm.x_s[tt][c], sm.b_s[tt], j);
#pragma unroll
      for (int k = 0; k < G::kGroups; ++k) sm.state(tt + 1, k, tid) = h[k];
    }
    __syncthreads();
    channel_sums<N, true>(sm, part, b, t0, nt, S, blocks, 1);  // dC
    __syncthreads();  // the walk overwrites the states the sums read
    for (int tt = nt - 1; tt >= 0; --tt) {
      const float dtv = sm.dt_s[tt][c], xv = sm.x_s[tt][c];
      const float dyv = sm.dy_s[tt][c], dtx = dtv * xv;
      float sdt = 0.f, sdx = 0.f;
#pragma unroll
      for (int k = 0; k < G::kGroups; ++k) {
        const int g4 = j + G::kLanes * k;
        const float4 hp = sm.state(tt, k, tid);  // h_{t-1}
        const float4 bq = reinterpret_cast<const float4*>(sm.b_s[tt])[g4];
        const float4 cq = reinterpret_cast<const float4*>(sm.c_s[tt])[g4];
        float4 w;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = ex2(dtv * at(a2[k], i));
          const float g = fmaf(dyv, at(cq, i), at(carry[k], i));
          const float ah = a * at(hp, i);
          const float bn = at(bq, i);
          sdt = fmaf(g, fmaf(at(av[k], i), ah, xv * bn), sdt);
          sdx = fmaf(g, bn, sdx);
          at(dacc[k], i) = fmaf(g * dtv, ah, at(dacc[k], i));
          at(carry[k], i) = a * g;
          at(w, i) = g * dtx;
        }
        sm.state(tt + 1, k, tid) = w;  // h_t is no longer needed
      }
      if (G::kLanes == 2) {  // both lanes have read this step's dt and x
        sdt += __shfl_xor_sync(0xffffffffu, sdt, 1);
        sdx += __shfl_xor_sync(0xffffffffu, sdx, 1);
      }
      if (j == 0) {
        sm.dt_s[tt][c] = sdt;
        sm.x_s[tt][c] = fmaf(dtv, sdx, dsk * dyv);
      }
      dd = fmaf(dyv, xv, dd);
    }
    __syncthreads();
    channel_sums<N, false>(sm, part, b, t0, nt, S, blocks, 0);  // dB
    for (int i = tid; i < kTile * kChannels; i += G::kThreads) {
      const int t = i / kChannels, cc = i % kChannels;
      if (t < nt && d0 + cc < D) {
        const size_t off = (static_cast<size_t>(b) * S + t0 + t) * D + d0
                           + cc;
        d_dt[off] = sm.dt_s[t][cc];
        dx[off] = from_float<TX>(sm.x_s[t][cc]);
      }
    }
  }

  if (live) {
#pragma unroll
    for (int k = 0; k < G::kGroups; ++k) {
      *reinterpret_cast<float4*>(dh0 + at_dn(b, k)) = carry[k];
      *reinterpret_cast<float4*>(part_a + at_dn(b, k)) = dacc[k];
    }
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
  auto kernel = mamba_scan_bwd_kernel<TX, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::kSmem));
  if (err != cudaSuccess) return err;
  const int blocks = (D + kChannels - 1) / kChannels;
  kernel<<<dim3(blocks, B), G::kThreads, G::kSmem, stream>>>(
      static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
      static_cast<const float*>(in[2]), static_cast<const TX*>(in[3]),
      static_cast<const float*>(in[4]), static_cast<const float*>(in[5]),
      static_cast<const float*>(in[6]), static_cast<const float*>(in[7]),
      static_cast<const float*>(in[8]), static_cast<float*>(out[0]),
      static_cast<TX*>(out[3]), static_cast<float*>(out[6]),
      static_cast<float*>(tmp[0]), static_cast<float*>(tmp[1]),
      static_cast<float*>(tmp[2]), static_cast<float*>(tmp[3]), S, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = 2 * static_cast<size_t>(B) * S * N
                       + static_cast<size_t>(D) * N + D;
  mamba_scan_bwd_sum<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                       stream>>>(
      static_cast<const float*>(tmp[1]), static_cast<const float*>(tmp[2]),
      static_cast<const float*>(tmp[3]), static_cast<float*>(out[1]),
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
                              const void* Dsk, const void* h0,
                              const void* dy, const void* dh_last,
                              void* d_dt, void* dBm, void* dCm, void* dx,
                              void* dA, void* dDsk, void* dh0, void* states,
                              void* part, void* part_a, void* part_d, int B,
                              int S, int D, int N, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return cudaErrorInvalidValue;
  const void* in[] = {dt, Bm, Cm, x, A, Dsk, h0, dy, dh_last};
  void* out[] = {d_dt, dBm, dCm, dx, dA, dDsk, dh0};
  void* tmp[] = {states, part, part_a, part_d};
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
