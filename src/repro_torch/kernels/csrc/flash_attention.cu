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
//   lse      [B, H, S] f32   optional, bf16 only: each row's log-sum-exp of
//                            its scaled scores (natural log; +inf for a row
//                            with no attendable key), which the autograd
//                            forward keeps for flash_attention_bwd.cu
//
// Query token p attends tokens t <= p (and t > p - window when a window is
// set, and t < lengths[b] when lengths are given).  With a prefix P > 0 the
// first P tokens also attend each other both ways: p attends t when t <= p
// or both are below P (and still t > p - window, t < lengths[b]), the mask
// of the reference's bidirectional prefix (a VLM's image patches; whisper's
// encoder, P = S).  It runs in every attention layer of
// TransformerLM.forward and .prefill, of the VLM's, and of whisper's
// encoder and decoder.
//
// What bounds it on the H100: operations.  A (b, kv head) does 4 * HD FLOP
// for each of its G * S * (S + 1) / 2 (query, key) pairs (S * window with a
// window, G * S * S with P = S) against 2 * S * HD elements of K and V: hundreds of FLOP per
// byte at S = 2048, far above the ~295 FLOP/byte ridge of bf16.
//
// What the design does about it: the body is chosen by dtype, and neither
// falls back to the other.
//
// * bf16 (dtype 1) runs on the tensor cores: flash_tc.cuh, a block of two
//   warpgroups per 128 query tokens of one query head, S = Q K^T and
//   O += P V as wgmma (bf16 in, fp32 accumulate; P rounded to bf16 in
//   registers as the A operand), the online softmax in fp32 registers,
//   K/V tiles through a two-stage cp.async ring shared by the two
//   warpgroups, tiles above the diagonal and outside the window never
//   visited, masks only on the tiles that straddle an edge, longest tiles
//   first.  See the note at its top.
// * fp32 (dtype 0) has no tensor-core path at full precision (TF32 would
//   round the inputs), so it runs as fp32 FMA on the CUDA cores (67
//   TFLOP/s): the staged walk of paged_common.cuh with a Dense walk.  One
//   block per (b, kv head, tile of 4096 / HD rows, at most 64) of the S * G
//   query rows of that kv head (row r is token r / G, query head r % G), so
//   each K/V stage is staged into shared memory once for the G heads of
//   the group and every row of the tile.  A tile walks only the slots
//   between its first row's window start and its last row's diagonal
//   (or the prefix's last token, for a tile with a row in the prefix;
//   capped at the sequence's length); the last tile's padding rows are
//   masked; blocks are issued longest tile first.
#include "flash_tc.cuh"
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

// bf16: flash_tc.cuh's kernel, two warpgroups a block.
template <int HD>
cudaError_t launch_tc(const flash_tc::Args& a, cudaStream_t stream) {
  using flash_tc::kGroups;
  constexpr size_t smem = flash_tc::smem_bytes<HD, kGroups>();
  const cudaError_t err =
      paged::allow_smem(flash_tc::flash_tc_kernel<HD, kGroups>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.S + flash_tc::kRows * kGroups - 1) /
                    (flash_tc::kRows * kGroups);
  flash_tc::flash_tc_kernel<HD, kGroups>
      <<<dim3(a.K * a.G, a.B, tiles), flash_tc::kWG * kGroups, smem,
         stream>>>(a);
  return cudaGetLastError();
}

cudaError_t by_head_dim_tc(int hd, const flash_tc::Args& a,
                           cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_tc<32>(a, stream);
    case 64: return launch_tc<64>(a, stream);
    case 128: return launch_tc<128>(a, stream);
    case 256: return launch_tc<256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v and out alike).  lengths may be null.
// lse may be null, and must be with dtype 0 (the fp32 backward computes its
// own).  window <= 0 means no window; prefix 0 means none (0 <= prefix <=
// S).  Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, const void* lengths,
                               void* out, void* lse, int B, int K, int G,
                               int hd, int S, int window, int prefix,
                               void* stream) {
  if (prefix < 0 || prefix > S) return cudaErrorInvalidValue;
  const paged::Args a{q, k, v, nullptr, nullptr, nullptr, nullptr, out,
                      B, S, K, G, window,
                      // q, out [B, K * G, S, HD]: row (b, token, h, g)
                      static_cast<long long>(K) * G * S, 1,
                      static_cast<long long>(G) * S, S};
  const paged::Dense w{static_cast<const int32_t*>(lengths), S, prefix};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      if (lse != nullptr) return cudaErrorInvalidValue;
      return by_head_dim<float>(hd, a, w, st);
    case 1:
      return by_head_dim_tc(
          hd,
          flash_tc::Args{static_cast<const __nv_bfloat16*>(q),
                         static_cast<const __nv_bfloat16*>(k),
                         static_cast<const __nv_bfloat16*>(v),
                         static_cast<const int32_t*>(lengths),
                         static_cast<__nv_bfloat16*>(out),
                         static_cast<float*>(lse), B, K, G, S, window,
                         prefix},
          st);
    default: return cudaErrorInvalidValue;
  }
}
