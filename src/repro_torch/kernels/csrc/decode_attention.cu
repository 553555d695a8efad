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
//   out        [B, K, G, HD]   type of q
//
// Slot c is valid iff tok >= 0 && tok <= pos (and tok > pos - window when a
// window is set).  It runs on every decode step of a ring-cache engine
// (ServeConfig.paged_kv=False) and of TransformerLM.decode_step after
// prefill, in every attention layer.
//
// What bounds it on the H100: device-memory bytes, as for paged decode:
// 2 * 2 * G * HD FLOP per valid slot against 2 * 2 * HD bytes (bf16) of K
// and V, about G FLOP per byte, far below the ~295 FLOP/byte ridge.
//
// What the design does about it: the staged walk of paged_common.cuh with
// a Ring walk.  One block per (b, kv head) first reads the row's C tokens
// (4 bytes a slot) and lists, in ring order, the slots the query may
// attend; then it streams only those slots' K and V through shared memory,
// once for all G query heads, as 16-byte loads one stage ahead, dequantizing
// int8 rows in registers.  Empty slots, future slots and slots outside the
// window are never read, so a window of 48 reads 48 slots of a 2048-slot
// ring.  What still holds it back: a grid of B * K blocks (32 at
// reflect_demo_100m's B 8, K 4; 8 at recurrentgemma-9b's K 1, G 16, HD
// 256) fills a fraction of the 132 SMs, so each stage's shared-memory chain
// waits exposed; splitting the walk across blocks (split-KV) is later work.
#include "paged_common.cuh"

namespace {

constexpr int kRows = 16;  // G <= 16 query rows per block

// TR query rows per block: 4 when G <= 4, 8 when G <= 8, else 16.
template <typename TQ, typename TKV, int HD, int TR>
__global__ void __launch_bounds__(paged::kThreads)
    decode_attention_kernel(paged::Args a, paged::Ring w) {
  extern __shared__ float4 smem[];
  paged::attend_rows<TQ, TKV, HD, TR>(a, w, blockIdx.y, blockIdx.x, 0,
                                      reinterpret_cast<float*>(smem));
}

template <typename TQ, typename TKV, int HD, int TR>
cudaError_t launch(const paged::Args& a, const paged::Ring& w,
                   cudaStream_t stream) {
  const size_t smem = paged::smem_bytes(HD, TR, w.C);
  const cudaError_t err =
      paged::allow_smem(decode_attention_kernel<TQ, TKV, HD, TR>, smem);
  if (err != cudaSuccess) return err;
  decode_attention_kernel<TQ, TKV, HD, TR>
      <<<dim3(a.K, a.B), paged::kThreads, smem, stream>>>(a, w);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int HD>
cudaError_t by_rows(const paged::Args& a, const paged::Ring& w,
                    cudaStream_t stream) {
  if (a.G <= 4) return launch<TQ, TKV, HD, 4>(a, w, stream);
  if (a.G <= 8) return launch<TQ, TKV, HD, 8>(a, w, stream);
  return launch<TQ, TKV, HD, kRows>(a, w, stream);
}

template <typename TQ, typename TKV>
cudaError_t by_head_dim(int hd, const paged::Args& a, const paged::Ring& w,
                        cudaStream_t stream) {
  switch (hd) {
    case 32: return by_rows<TQ, TKV, 32>(a, w, stream);
    case 64: return by_rows<TQ, TKV, 64>(a, w, stream);
    case 128: return by_rows<TQ, TKV, 128>(a, w, stream);
    case 256: return by_rows<TQ, TKV, 256>(a, w, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32 q and ring, 1 = bf16 q and ring, 2 = f32 q + int8 ring,
// 3 = bf16 q + int8 ring.  window <= 0 means no window.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int decode_attention(int dtype, const void* q, const void* k,
                                const void* v, const void* ks,
                                const void* kz, const void* vs,
                                const void* tok, const void* pos, void* out,
                                int B, int K, int G, int hd, int C,
                                int window, void* stream) {
  if (G > kRows) return cudaErrorInvalidValue;
  const paged::Args a{q, k, v,
                      static_cast<const float*>(ks),
                      static_cast<const float*>(kz),
                      static_cast<const float*>(vs),
                      static_cast<const int32_t*>(pos), out,
                      B, 1, K, G, window,
                      // q, out [B, K, G, HD]
                      static_cast<long long>(K) * G, 0, G, 1};
  const paged::Ring w{static_cast<const int32_t*>(tok), C};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return by_head_dim<float, float>(hd, a, w, st);
    case 1: return by_head_dim<__nv_bfloat16, __nv_bfloat16>(hd, a, w, st);
    case 2: return by_head_dim<float, int8_t>(hd, a, w, st);
    case 3: return by_head_dim<__nv_bfloat16, int8_t>(hd, a, w, st);
    default: return cudaErrorInvalidValue;
  }
}
