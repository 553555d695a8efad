// Ring-cache decode attention for Hopper (sm_90a): one query position per
// request over a dense ring of C slots.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, body _decode_kernel), which streams kv tiles of the
// ring through VMEM on a sequential (B, K, C / bk) grid and masks each
// slot by the token it holds.
//
//   q          [B, K, G, HD]   float or bf16 (HD in {32, 64, 128, 256},
//                              G <= 16)
//   k/v        [B, C, K, HD]   same type as q, or int8 with f32 sidecars
//   k/z/v scale[B, C, K]       int8 only: K = (q + 128) * s + z, V = q * s
//   tok        [B, C] int32    absolute token held by each slot, -1 = empty
//   pos        [B] int32       absolute position of the query
//   part       [B, K, splits, G, HD + 2] float scratch (acc, m, l)
//   out        [B, K, G, HD]   type of q
//
// Slot c is valid iff tok >= 0 && tok <= pos (and tok > pos - window when a
// window is set).  It runs on every decode step of a ring-cache engine
// (ServeConfig.paged_kv=False) and of TransformerLM.decode_step after
// prefill, in every attention layer.
//
// What bounds it on the H100: device-memory bytes, as for paged decode:
// 2 * 2 * G * HD FLOP per valid slot against 2 * 2 * HD bytes (bf16) of K
// and V, about G FLOP per byte, far below the ~295 FLOP/byte ridge.  So
// the card is only as fast as the number of SMs that keep loads in flight.
//
// What the design does about it: the ring of each (b, kv head) is split
// into ``splits`` segments of consecutive slots (cuda_lib.ring_splits:
// about two blocks per SM over the B * K rows, at least one stage of
// slots each), and the grid is (splits, K, B): 33 blocks a row at
// recurrentgemma-9b's B 8, K 1 instead of one.  A block runs the staged
// walk of paged_common.cuh with a Ring walk over its segment: it reads
// the segment's tokens (4 bytes a slot), lists in ring order the slots
// the query may attend, and streams only those slots' K and V through
// shared memory once for all G query heads, as 16-byte loads one stage
// ahead, dequantizing int8 rows in registers.  Empty slots, future slots
// and slots outside the window are never read.  Each block writes its G
// rows' unnormalized (acc, m, l) to ``part``; a second kernel, launched
// from the same entry point (paged::combine, shared with the paged
// kernels), combines the splits of each row in split order,
//
//   out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s,  M = max m_s,
//
// skipping splits with no slot (l = 0); a row with none is zeros.  The
// order is fixed, so results are bit-identical from run to run, and one
// split gives acc / l exactly.
#include "paged_common.cuh"

namespace {

constexpr int kRows = 16;  // G <= 16 query rows per block

// TR query rows per block: 4 when G <= 4, 8 when G <= 8, else 16.
template <typename TQ, typename TKV, int HD, int TR>
__global__ void __launch_bounds__(paged::kThreads)
    decode_attention_kernel(paged::Args a, paged::Ring w, float* part) {
  extern __shared__ float4 smem[];
  w.split = blockIdx.x;
  paged::attend_rows<TQ, TKV, HD, TR>(
      a, w, blockIdx.z, blockIdx.y, 0, reinterpret_cast<float*>(smem),
      paged::Partial{part, w.splits, w.split});
}

template <typename TQ, typename TKV, int HD, int TR>
cudaError_t launch(const paged::Args& a, const paged::Ring& w, float* part,
                   cudaStream_t stream) {
  const size_t smem =
      paged::smem_bytes(HD, TR, (w.C + w.splits - 1) / w.splits);
  const cudaError_t err =
      paged::allow_smem(decode_attention_kernel<TQ, TKV, HD, TR>, smem);
  if (err != cudaSuccess) return err;
  decode_attention_kernel<TQ, TKV, HD, TR>
      <<<dim3(w.splits, a.K, a.B), paged::kThreads, smem, stream>>>(a, w,
                                                                   part);
  const cudaError_t split_err = cudaGetLastError();
  if (split_err != cudaSuccess) return split_err;
  return paged::combine<TQ, HD>(a, part, w.splits, stream);
}

template <typename TQ, typename TKV, int HD>
cudaError_t by_rows(const paged::Args& a, const paged::Ring& w, float* part,
                    cudaStream_t stream) {
  if (a.G <= 4) return launch<TQ, TKV, HD, 4>(a, w, part, stream);
  if (a.G <= 8) return launch<TQ, TKV, HD, 8>(a, w, part, stream);
  return launch<TQ, TKV, HD, kRows>(a, w, part, stream);
}

template <typename TQ, typename TKV>
cudaError_t by_head_dim(int hd, const paged::Args& a, const paged::Ring& w,
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

// dtype: 0 = f32 q and ring, 1 = bf16 q and ring, 2 = f32 q + int8 ring,
// 3 = bf16 q + int8 ring.  window <= 0 means no window.  part holds
// B * K * splits * G * (hd + 2) floats; 1 <= splits <= C.  Returns the
// cudaError_t of the launches (0 = success).
extern "C" int decode_attention(int dtype, const void* q, const void* k,
                                const void* v, const void* ks,
                                const void* kz, const void* vs,
                                const void* tok, const void* pos, void* out,
                                void* part, int B, int K, int G, int hd,
                                int C, int window, int splits,
                                void* stream) {
  if (G > kRows || splits < 1 || splits > C) return cudaErrorInvalidValue;
  const paged::Args a{q, k, v,
                      static_cast<const float*>(ks),
                      static_cast<const float*>(kz),
                      static_cast<const float*>(vs),
                      static_cast<const int32_t*>(pos), out,
                      B, 1, K, G, window,
                      // q, out [B, K, G, HD]
                      static_cast<long long>(K) * G, 0, G, 1};
  const paged::Ring w{static_cast<const int32_t*>(tok), C, splits, 0};
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
