// Flash attention for Hopper (sm_90a): causal grouped-query attention over
// full sequences, with an optional sliding window and per-sequence lengths.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel), whose grid (B, H, S / bq) gives
// each program one query tile of one head and streams the kv tiles between
// the window's start and the diagonal through VMEM with an online softmax.
//
//   q        [B, H, S, HD]   float or bf16 (H = K * G, HD in {32, 64, 128,
//                            256})
//   k/v      [B, K, S, HD]   same type as q
//   lengths  [B] int32       optional: token t is attendable iff t < len
//   out      [B, H, S, HD]   type of q
//
// Query token p attends tokens t <= p (and t > p - window when a window is
// set, and t < lengths[b] when lengths are given).  It runs in every
// attention layer of TransformerLM.forward and .prefill.
//
// What bounds it on the H100: operations.  A (b, kv head) does 4 * HD FLOP
// for each of its G * S * (S + 1) / 2 (query, key) pairs (S * window with a
// window) against 2 * S * HD elements of K and V: hundreds of FLOP per
// byte at S = 2048, above the ridge.  This kernel runs them as fp32 FMA
// (67 TFLOP/s), not on the tensor cores (989 TFLOP/s bf16); mma.sync or
// wgmma is later work.
//
// What the design does about it: the staged walk of paged_common.cuh with
// a Dense walk.  One block per (b, kv head, tile of 4096 / HD rows, at
// most 64) of the S * G query rows of that kv head (row r is token r / G,
// query head r % G), so each K/V stage is staged into shared memory once
// for the G heads of the group and every row of the tile.  A tile walks
// only the slots between its first row's window start and its last row's
// diagonal (capped at the sequence's length), so tiles above the diagonal
// and outside the window are never visited; any S works, the last tile's
// padding rows are masked.  Softmax and accumulation are fp32.  Blocks are
// issued longest tile first.
#include "paged_common.cuh"

namespace {

// Rows of a tile: 64 at HD <= 64, 32 at HD 128, 16 at HD 256 (at most 32
// accumulators per thread).
template <int HD>
constexpr int kRows = 4096 / HD < 64 ? 4096 / HD : 64;

template <typename T, int HD>
__global__ void __launch_bounds__(paged::kThreads)
    flash_attention_kernel(paged::Args a, paged::Dense w) {
  extern __shared__ float4 smem[];
  constexpr int TR = kRows<HD>;
  const int tile = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  paged::attend_rows<T, T, HD, TR>(a, w, blockIdx.z, blockIdx.y, tile * TR,
                                   reinterpret_cast<float*>(smem));
}

template <typename T, int HD>
cudaError_t launch(const paged::Args& a, const paged::Dense& w,
                   cudaStream_t stream) {
  constexpr int TR = kRows<HD>;
  const int tiles = (a.Sx * a.G + TR - 1) / TR;
  const size_t smem = paged::smem_bytes(HD, TR, 0);
  const cudaError_t err =
      paged::allow_smem(flash_attention_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  flash_attention_kernel<T, HD>
      <<<dim3(tiles, a.K, a.B), paged::kThreads, smem, stream>>>(a, w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_head_dim(int hd, const paged::Args& a, const paged::Dense& w,
                        cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, w, stream);
    case 64: return launch<T, 64>(a, w, stream);
    case 128: return launch<T, 128>(a, w, stream);
    case 256: return launch<T, 256>(a, w, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v and out alike).  lengths may be null.
// window <= 0 means no window.  Returns the cudaError_t of the launch
// (0 = success).
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, const void* lengths,
                               void* out, int B, int K, int G, int hd, int S,
                               int window, void* stream) {
  const paged::Args a{q, k, v, nullptr, nullptr, nullptr, nullptr, out,
                      B, S, K, G, window,
                      // q, out [B, K * G, S, HD]: row (b, token, h, g)
                      static_cast<long long>(K) * G * S, 1,
                      static_cast<long long>(G) * S, S};
  const paged::Dense w{static_cast<const int32_t*>(lengths), S};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return by_head_dim<float>(hd, a, w, st);
    case 1: return by_head_dim<__nv_bfloat16>(hd, a, w, st);
    default: return cudaErrorInvalidValue;
  }
}
