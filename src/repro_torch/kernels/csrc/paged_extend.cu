// Paged extend / verify attention for Hopper (sm_90a): Sx query lanes per
// request over a paged KV pool, with a per-lane staircase mask.
//
// Replaces the TPU kernel src/repro/kernels/paged_extend.py
// (paged_extend_attention, body _extend_kernel), which keeps all Sx * G
// rows of a (b, kv head) resident in VMEM while pages stream through a
// sequential grid axis.
//
//   q          [B, Sx, K, G, HD] float or bf16 (HD in {32, 64, 128, 256})
//   k/v pool   [P, ps, K, HD]    same type as q, or int8 with f32 sidecars
//   k/z/v scale[P, ps, K]        int8 only: K = (q + 128) * s + z, V = q * s
//   page_table [B, NP] int32     -1 = unmapped
//   pos0       [B] int32         absolute position of lane 0
//   out        [B, Sx, K, G, HD] type of q
//
// Lane l sits at pos0 + l and attends slots t <= pos0 + l (and
// t > pos0 + l - window when a window is set).  It runs on every prefill
// chunk and mixed step (Sx = prefill_chunk, 32 lanes -> 96 rows at G = 3)
// and every speculative verify step (Sx = 1 + spec_tokens, 5 lanes -> 15
// rows).
//
// What bounds it on the H100: device-memory bytes at verify widths (15
// rows reuse each K/V byte ~15 times: ~15 FLOP per byte, far below the
// ~295 FLOP/byte ridge); at a 96-row prefill chunk the arithmetic per byte
// is 6x higher but still below the ridge, and with fp32 FMA instead of
// tensor cores the FMA rate (67 TFLOP/s) is the nearer roof.
//
// What the design does about it: one block per (b, kv head, tile of
// 1024 / HD rows).  Each slot a row of the tile can attend is staged into
// shared memory once per block and used by every row of the tile (the
// page-read-once contract of the TPU kernel, held per block), as 16-byte
// loads issued one stage of 4096 / HD slots ahead of the stage being
// computed; slots on unmapped pages, past the tile's last lane or before
// its window are never read, and int8 pages are dequantized in registers.
// A 96-row chunk at HD = 64 spans 6 tiles, which read the same pages
// through L2.  At HD = 256 (recurrentgemma-9b's MQA local attention, G =
// 16) a tile is 16 rows, one lane's query heads, so a 32-lane prefill
// chunk spans 32 tiles of a 2048-slot window.  wgmma on the row tile, TMA page loads and split-KV are later
// steps.
#include "paged_common.cuh"

namespace {

// Rows of a tile: 1024 / HD (8 accumulators per thread), and 16 at HD = 256
// (32 accumulators per thread).
template <int HD>
constexpr int kRows = HD == 256 ? 16 : 1024 / HD;

template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(paged::kThreads)
    paged_extend_kernel(paged::Args a, paged::Pages w) {
  extern __shared__ float4 smem[];
  constexpr int TR = kRows<HD>;
  paged::attend_rows<TQ, TKV, HD, TR>(a, w, blockIdx.z, blockIdx.y,
                                      blockIdx.x * TR,
                                      reinterpret_cast<float*>(smem));
}

template <typename TQ, typename TKV, int HD>
cudaError_t launch(const paged::Args& a, const paged::Pages& w,
                   cudaStream_t stream) {
  constexpr int TR = kRows<HD>;
  const int tiles = (a.Sx * a.G + TR - 1) / TR;
  const size_t smem = paged::smem_bytes(HD, TR, w.NP);
  const cudaError_t err =
      paged::allow_smem(paged_extend_kernel<TQ, TKV, HD>, smem);
  if (err != cudaSuccess) return err;
  paged_extend_kernel<TQ, TKV, HD>
      <<<dim3(tiles, a.K, a.B), paged::kThreads, smem, stream>>>(a, w);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t by_head_dim(int hd, const paged::Args& a, const paged::Pages& w,
                        cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<TQ, TKV, 32>(a, w, stream);
    case 64: return launch<TQ, TKV, 64>(a, w, stream);
    case 128: return launch<TQ, TKV, 128>(a, w, stream);
    case 256: return launch<TQ, TKV, 256>(a, w, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32 q and pool, 1 = bf16 q and pool, 2 = f32 q + int8 pool,
// 3 = bf16 q + int8 pool.  window <= 0 means no window.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int paged_extend(int dtype, const void* q, const void* kp,
                            const void* vp, const void* ks, const void* kz,
                            const void* vs, const void* page_table,
                            const void* pos0, void* out, int B, int Sx, int K,
                            int G, int hd, int ps, int NP, int window,
                            void* stream) {
  const paged::Args a{q, kp, vp,
                      static_cast<const float*>(ks),
                      static_cast<const float*>(kz),
                      static_cast<const float*>(vs),
                      static_cast<const int32_t*>(pos0), out,
                      B, Sx, K, G, window,
                      // q, out [B, Sx, K, G, HD]
                      static_cast<long long>(Sx) * K * G,
                      static_cast<long long>(K) * G, G, 1};
  const paged::Pages w{static_cast<const int32_t*>(page_table), ps, NP};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return by_head_dim<float, float>(hd, a, w, st);
    case 1: return by_head_dim<__nv_bfloat16, __nv_bfloat16>(hd, a, w, st);
    case 2: return by_head_dim<float, int8_t>(hd, a, w, st);
    case 3: return by_head_dim<__nv_bfloat16, int8_t>(hd, a, w, st);
    default: return cudaErrorInvalidValue;
  }
}
