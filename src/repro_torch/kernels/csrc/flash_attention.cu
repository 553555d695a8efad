// Flash attention for Hopper (sm_90a): causal grouped-query attention over
// full sequences, with an optional sliding window and per-sequence lengths.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel), whose grid (B, H, S / bq) gives
// each program one query tile of one head and streams the kv tiles between
// the window's start and the diagonal through VMEM with an online softmax.
//
//   q        [B, H, S, HD]   float or bf16 (H = K * G, HD in {32, 64, 128,
//                            192, 256}; the backward, flash_attention_bwd.cu,
//                            takes 32, 64, 128 and 256)
//   k/v      [B, K, S, HD]   same type as q
//   lengths  [B] int32       optional: token t is attendable iff t < len
//   out      [B, H, S, HD]   type of q
//   lse      [B, H, S] f32   optional: each row's log-sum-exp of its scaled
//                            scores (natural log; +inf for a row with no
//                            attendable key), which the autograd forward
//                            keeps for flash_attention_bwd.cu
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
// window, G * S * S with P = S) against 2 * S * HD elements of K and V:
// hundreds of FLOP per byte at S = 2048, far above the ~295 FLOP/byte
// ridge of bf16.
//
// What the design does about it: both bodies run on the tensor cores, the
// body chosen by dtype, and neither falls back to the other.
//
// * bf16 (dtype 1): flash_tc.cuh, a block of two warpgroups per 128 query
//   tokens of one query head, S = Q K^T and O += P V as wgmma (bf16 in,
//   fp32 accumulate; P rounded to bf16 in registers as the A operand), the
//   online softmax in fp32 registers, K/V tiles through a two-stage
//   cp.async ring shared by the two warpgroups, tiles above the diagonal
//   and outside the window never visited, masks only on the tiles that
//   straddle an edge, longest tiles first.  See the note at its top.
// * fp32 (dtype 0): flash_tf32.cuh, the same walk with each product as
//   three TF32 wgmma products (lo hi + hi lo + hi hi of the inputs split
//   in registers), which keeps fp32's accuracy to about 2^-21 at an
//   effective 165 TFLOP/s (495 / 3) against 67 TFLOP/s of FMA.  TF32
//   operands must be K-major, so V is split and stored transposed on its
//   way into shared memory, its keys permuted so that P's accumulator
//   registers are the A fragments as they stand.  See the note at its top.
#include "flash_tc.cuh"
#include "flash_tf32.cuh"

namespace {

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// fp32: flash_tf32.cuh's kernel, 3xTF32 on wgmma.
template <int HD>
cudaError_t launch_tf32(const flash_tf32::Args& a, cudaStream_t stream) {
  namespace tf = flash_tf32;
  constexpr size_t smem = tf::fwd_smem<HD>();
  static_assert(smem <= 232448, "shared memory");
  const cudaError_t err = allow_smem(tf::fwd_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  constexpr int QR = flash_tc::kRows * tf::fwd_groups<HD>();
  tf::fwd_kernel<HD><<<dim3(a.K * a.G, a.B, (a.S + QR - 1) / QR),
                       flash_tc::kWG * tf::fwd_groups<HD>(), smem, stream>>>(
      a);
  return cudaGetLastError();
}

cudaError_t by_head_dim_tf32(int hd, const flash_tf32::Args& a,
                             cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_tf32<32>(a, stream);
    case 64: return launch_tf32<64>(a, stream);
    case 128: return launch_tf32<128>(a, stream);
    case 192: return launch_tf32<192>(a, stream);
    case 256: return launch_tf32<256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// bf16: flash_tc.cuh's kernel, two warpgroups a block.
template <int HD>
cudaError_t launch_tc(const flash_tc::Args& a, cudaStream_t stream) {
  using flash_tc::kGroups;
  constexpr size_t smem = flash_tc::smem_bytes<HD, kGroups>();
  const cudaError_t err =
      allow_smem(flash_tc::flash_tc_kernel<HD, kGroups>, smem);
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
    case 192: return launch_tc<192>(a, stream);
    case 256: return launch_tc<256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v and out alike).  lengths and lse may
// be null.  window <= 0 means no window; prefix 0 means none (0 <= prefix
// <= S).  Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, const void* lengths,
                               void* out, void* lse, int B, int K, int G,
                               int hd, int S, int window, int prefix,
                               void* stream) {
  if (prefix < 0 || prefix > S) return cudaErrorInvalidValue;
  const int32_t* len = static_cast<const int32_t*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return by_head_dim_tf32(
          hd,
          flash_tf32::Args{static_cast<const float*>(q),
                           static_cast<const float*>(k),
                           static_cast<const float*>(v), len,
                           static_cast<float*>(out), static_cast<float*>(lse),
                           B, K, G, S, window, prefix},
          st);
    case 1:
      return by_head_dim_tc(
          hd,
          flash_tc::Args{static_cast<const __nv_bfloat16*>(q),
                         static_cast<const __nv_bfloat16*>(k),
                         static_cast<const __nv_bfloat16*>(v), len,
                         static_cast<__nv_bfloat16*>(out),
                         static_cast<float*>(lse), B, K, G, S, window,
                         prefix},
          st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
