// K2: attention forward for the VAE mid-block (one head, d=512, 4096
// tokens), and the same forward with residuals for training (K2r: the
// UNet's self-attention at d = 40 and 80, and the VAE decoder's d = 512).
//
// Replaces: reface_tpu/ops/attention.py:_flash_attention, the call into the
// library kernel jax.experimental.pallas.ops.tpu.flash_attention: its forward
// (reface_wide_attention) and its forward with save_residuals=True, which the
// library's custom VJP runs before its backward kernels
// (reface_flash_attention_fwd; the backward is attention_flash_bwd.cu).
// Both follow the library's row-sum rule: the fp32 probabilities go into
// the row sum and are rounded to the input dtype only for the PV product;
// the second entry point also writes lse.
//
// Dispatch by dtype, not a fallback:
//   bf16 -> attention_fwd_sm90.cuh, the Hopper kernel (wgmma, TMA, a
//           producer warpgroup; D = 512 split over two consumer warpgroups
//           that exchange partial scores, so no product is recomputed);
//   fp32 -> attn_fwd_kernel of attention_common.cuh, the scalar streaming
//           kernel, which the card's fp32 checks hold to the plain version
//           at 2e-5 (D > 128 is cut into 128-column slices that each
//           recompute the scores; fp32 serves only those checks and the tiny
//           fp32 steps).
// Both accept D a multiple of 8 up to 128, or 256, 384, 512.
#include "attention_common.cuh"
#include "attention_fwd_sm90.cuh"

namespace {

bool head_dim_ok(int d) { return d > 0 && d % 8 == 0 && (d <= 128 || (d % 128 == 0 && d <= 512)); }

}  // namespace

namespace reface {
namespace sm90 {

// The bf16 forward at any D the entry points take: multiples of 8 up to 128,
// and 256, 384, 512. lse may be nullptr (K2 without residuals).
inline int attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                              int bh, int n, int m, int d, float scale_log2, cudaStream_t s) {
  if (d <= 128) return attention_fwd_bf16_d128<false>(q, k, v, o, lse, bh, n, m, d, scale_log2, s);
  switch (d) {
    case 256: return launch<256, 8, 32, true>(q, k, v, o, lse, bh, n, m, d, scale_log2, s);
    case 384: return launch<384, 12, 32, true>(q, k, v, o, lse, bh, n, m, d, scale_log2, s);
    case 512: return launch<512, 16, 32, true>(q, k, v, o, lse, bh, n, m, d, scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace reface

extern "C" int reface_wide_attention(const void* q, const void* k,
                                     const void* v, void* o, int bh, int n,
                                     int m, int d, float scale_log2, int dtype,
                                     void* stream) {
  if (!head_dim_ok(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return reface::sm90::attention_fwd_bf16(q, k, v, o, nullptr, bh, n, m, d, scale_log2, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return reface::launch_attn<float, 16, false>(q, k, v, o, nullptr, bh, n, m, d,
                                               d <= 128 ? d : 128, scale_log2, 0, s);
}

// The training forward: o as above plus one fp32 log-sum-exp per query row.
// In fp32 the UNet's heads (d = 40, 80) are one slice; wider heads are
// sliced and the first slice writes lse.
extern "C" int reface_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int bh, int n, int m, int d,
                                          float scale_log2, int dtype,
                                          void* stream) {
  if (!head_dim_ok(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 1)
    return reface::sm90::attention_fwd_bf16(q, k, v, o, l, bh, n, m, d, scale_log2, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  using reface::launch_attn;
  if (d <= 48) return launch_attn<float, 6, true>(q, k, v, o, l, bh, n, m, d, d, scale_log2, 0, s);
  if (d <= 96) return launch_attn<float, 12, true>(q, k, v, o, l, bh, n, m, d, d, scale_log2, 0, s);
  return launch_attn<float, 16, true>(q, k, v, o, l, bh, n, m, d, d <= 128 ? d : 128,
                                      scale_log2, 0, s);
}
