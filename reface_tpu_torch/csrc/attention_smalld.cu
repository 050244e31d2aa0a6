// K1: small-head-dim self-attention for the UNet (8 heads of d=40 over 4096
// tokens, d=80 over 1024 tokens).
//
// Replaces: reface_tpu/ops/attention_smalld.py:self_attention_smalld, both
// its "nn" kernel (_kernel, :118) and its "tn" kernel (_kernel_tn, :141); the
// nn/tn split was a TPU operand-layout device and has no Hopper counterpart.
// Their function, which bf16 keeps here: one fixed shift per row, the max of
// the scaled scores over the first 256 keys (none with `fast`), p rounded to
// bf16, and the row sum taken over the rounded p (the TPU kernel's
// ones-column), fp32 accumulation.
//
// Bound on the card: the exponential unit at D = 40 (one exp2 a score,
// BH N^2 = 268 M at (16, 4096, 40): 0.069 ms), the tensor cores at the
// padded widths close behind; far above the bytes (4 N D BH x 2 = 21 MB).
//
// Dispatch, by dtype and by shape, never as a fallback:
//   bf16, D <= 128 -> attention_fwd_sm90.cuh (wgmma, TMA, a producer
//     warpgroup, the two consumer warpgroups in ping-pong) with K1's rules
//     (kSmalld: the fixed shift and the rounded row sum);
//   bf16, 128 < D <= 256 -> attn_fwd_kernel of attention_common.cuh
//     (mma.sync) with the same rules under its own kSmalld option: a
//     prologue runs QK^T over the first 256 keys for the fixed shift, and
//     the rounded p are summed in registers. The 512 px UNet does not reach
//     it (its d = 160 level has 256 tokens, which ops/attention.py sends to
//     einsum); a 1024 px input does (1024 tokens at d = 160). It stays on
//     mma.sync: it is off the main path;
//   fp32 -> attn_fwd_kernel's scalar path, where rounding p is a no-op and
//     the shift is exact either way; the card holds it to the plain version
//     at 2e-5.
#include "attention_common.cuh"
#include "attention_fwd_sm90.cuh"

extern "C" int reface_smalld_attention(const void* q, const void* k,
                                       const void* v, void* o, int bh, int n,
                                       int d, float scale_log2, int fast,
                                       int dtype, void* stream) {
  if (d <= 0 || d > 256 || d % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using namespace reface;
  if (dtype == 1) {
    if (d <= 128)
      return sm90::attention_fwd_bf16_d128<true>(q, k, v, o, nullptr, bh, n, n, d, scale_log2, s,
                                                 fast);
    return launch_attn<__nv_bfloat16, 32, false, true>(q, k, v, o, nullptr, bh, n, n, d, d,
                                                       scale_log2, fast, s);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if (d <= 48) return launch_attn<float, 6, false>(q, k, v, o, nullptr, bh, n, n, d, d, scale_log2, fast, s);
  if (d <= 96) return launch_attn<float, 12, false>(q, k, v, o, nullptr, bh, n, n, d, d, scale_log2, fast, s);
  if (d <= 128) return launch_attn<float, 16, false>(q, k, v, o, nullptr, bh, n, n, d, d, scale_log2, fast, s);
  return launch_attn<float, 32, false>(q, k, v, o, nullptr, bh, n, n, d, d, scale_log2, fast, s);
}
