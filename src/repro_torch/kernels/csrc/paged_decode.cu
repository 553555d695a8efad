// Paged decode attention for Hopper (sm_90a): one query position per
// request over a paged KV pool.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (paged_decode_attention, body _paged_kernel), which walks the page table
// through scalar prefetch on a sequential (B, K, NP) grid.
//
//   q          [B, K, G, HD]   float or bf16 (HD in {32, 64, 128, 256},
//                              G <= 16)
//   k/v pool   [P, ps, K, HD]  same type as q, or int8 with f32 sidecars
//   k/z/v scale[P, ps, K]      int8 only: K = (q + 128) * s + z, V = q * s
//   page_table [B, NP] int32   -1 = unmapped
//   pos        [B] int32       absolute position of the query
//   part       [B, K, splits, G, HD + 2] float scratch (acc, m, l)
//   out        [B, K, G, HD]   type of q
//
// What bounds it on the H100: device-memory bytes.  Every (b, h) reads its
// L cached K and V rows once and does 2 * 2 * G * HD FLOP per cached token
// against 2 * 2 * HD bytes (bf16) of K and V: at the main path's G = 3 that
// is about 3 FLOP per byte, two orders of magnitude below the card's
// ~295 FLOP/byte ridge, so the tensor cores would idle; fp32 FMA is enough.
// So the card is only as fast as the number of SMs that keep loads in
// flight: one block per (b, h) gave 32 blocks at the demo's B 8, K 4 and 8
// at recurrentgemma-9b's K 1, each walking its whole row in a chain of
// stages.
//
// What the design does about it: the attendable range of each (b, h),
// [max(0, pos - window + 1), pos], is split into ``splits`` segments of
// whole stages (cuda_lib.paged_splits: about two blocks per SM over the
// B * K rows, never more segments than stages in the table), and the grid
// is (splits, K, B): 9 blocks a row at the demo's shape, 33 at
// recurrentgemma-9b's.  The split follows the row's own range, read from
// pos on the device, so a short row's stages spread over all its blocks
// and the rest find an empty segment and only write (m = -inf, l = 0).
// A block runs the staged walk of paged_common.cuh over its segment:
// it stages the segment's page-table entries, then streams the slots'
// K and V through shared memory once for all G query heads of the group
// (the grouped-query reuse), as 16-byte loads issued one stage of
// 4096 / HD slots ahead of the stage being computed; it never reads
// slots on unmapped pages, past pos or before the window, and dequantizes
// int8 pages in registers so an int8 pool moves half the bytes of a bf16
// one.  Each block writes its G rows' unnormalized (acc, m, l) to
// ``part``, and paged::combine, launched from the same entry point, adds
// the splits of each row in split order: bit-identical from run to run.
//
// recurrentgemma-9b's local-attention blocks are MQA at HD = 256 with
// G = 16 query heads per KV head: blocks of 16 rows, stages of 32 slots,
// a 2048-slot window.
#include "paged_common.cuh"

namespace {

constexpr int kRows = 16;  // G <= 16 query rows per block

// TR query rows per block: 4 when G <= 4, 8 when G <= 8, else 16.
template <typename TQ, typename TKV, int HD, int TR>
__global__ void __launch_bounds__(paged::kThreads)
    paged_decode_kernel(paged::Args a, paged::Pages w, float* part) {
  extern __shared__ float4 smem[];
  w.split = blockIdx.x;
  paged::attend_rows<TQ, TKV, HD, TR>(
      a, w, blockIdx.z, blockIdx.y, 0, reinterpret_cast<float*>(smem),
      paged::Partial{part, w.splits, w.split});
}

template <typename TQ, typename TKV, int HD, int TR>
cudaError_t launch(const paged::Args& a, paged::Pages w, float* part,
                   cudaStream_t stream) {
  w.stage = paged::stage_slots(HD);
  const size_t smem = paged::smem_bytes(HD, TR, w.NP);
  const cudaError_t err =
      paged::allow_smem(paged_decode_kernel<TQ, TKV, HD, TR>, smem);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<TQ, TKV, HD, TR>
      <<<dim3(w.splits, a.K, a.B), paged::kThreads, smem, stream>>>(a, w,
                                                                   part);
  const cudaError_t split_err = cudaGetLastError();
  if (split_err != cudaSuccess) return split_err;
  return paged::combine<TQ, HD>(a, part, w.splits, stream);
}

template <typename TQ, typename TKV, int HD>
cudaError_t by_rows(const paged::Args& a, const paged::Pages& w,
                    float* part, cudaStream_t stream) {
  if (a.G <= 4) return launch<TQ, TKV, HD, 4>(a, w, part, stream);
  if (a.G <= 8) return launch<TQ, TKV, HD, 8>(a, w, part, stream);
  return launch<TQ, TKV, HD, kRows>(a, w, part, stream);
}

template <typename TQ, typename TKV>
cudaError_t by_head_dim(int hd, const paged::Args& a, const paged::Pages& w,
                        float* part, cudaStream_t stream) {
  switch (hd) {
    case 32: return by_rows<TQ, TKV, 32>(a, w, part, stream);
    case 64: return by_rows<TQ, TKV, 64>(a, w, part, stream);
    case 128: return by_rows<TQ, TKV, 128>(a, w, part, stream);
    case 256: return by_rows<TQ, TKV, 256>(a, w, part, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32 q and pool, 1 = bf16 q and pool, 2 = f32 q + int8 pool,
// 3 = bf16 q + int8 pool.  window <= 0 means no window.  part holds
// B * K * splits * G * (hd + 2) floats; splits >= 1.  Returns the
// cudaError_t of the launches (0 = success).
extern "C" int paged_decode(int dtype, const void* q, const void* kp,
                            const void* vp, const void* ks, const void* kz,
                            const void* vs, const void* page_table,
                            const void* pos, void* out, void* part, int B,
                            int K, int G, int hd, int ps, int NP, int window,
                            int splits, void* stream) {
  if (G > kRows || splits < 1) return cudaErrorInvalidValue;
  const paged::Args a{q, kp, vp,
                      static_cast<const float*>(ks),
                      static_cast<const float*>(kz),
                      static_cast<const float*>(vs),
                      static_cast<const int32_t*>(pos), out,
                      B, 1, K, G, window,
                      // q, out [B, K, G, HD]
                      static_cast<long long>(K) * G, 0, G, 1};
  const paged::Pages w{static_cast<const int32_t*>(page_table), ps, NP,
                       splits};
  float* p = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return by_head_dim<float, float>(hd, a, w, p, st);
    case 1: return by_head_dim<__nv_bfloat16, __nv_bfloat16>(hd, a, w, p, st);
    case 2: return by_head_dim<float, int8_t>(hd, a, w, p, st);
    case 3: return by_head_dim<__nv_bfloat16, int8_t>(hd, a, w, p, st);
    default: return cudaErrorInvalidValue;
  }
}
