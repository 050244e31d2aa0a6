// K2: wide-head attention forward for the VAE mid-block (one head, d=512,
// 4096 tokens), and the same forward with residuals for training.
//
// Replaces: reface_tpu/ops/attention.py:_flash_attention, the call into the
// library kernel jax.experimental.pallas.ops.tpu.flash_attention: its forward
// (reface_wide_attention) and its forward with save_residuals=True, which the
// library's custom VJP runs before its backward kernels
// (reface_flash_attention_fwd; the backward is attention_flash_bwd.cu).
//
// Bound on the card: operations. At (B, N, D) = (2, 4096, 512) the two
// products are 4*N^2*D*B = 69 GFLOP against 4*N*D*B*2 bytes = 34 MB.
//
// Design: a 64-row fp32 accumulator over all 512 columns is 128 KB, too
// large for one block's registers. The head dimension is split across
// blocks: each block owns one 128-wide slice of the output (grid.y = 4) and
// recomputes the scores from the full 512-wide dot products, streaming K
// through shared memory in 128-column chunks. The recomputation costs 4x the
// QK^T work (2.5x the total) but keeps the kernel the same streaming kernel
// as K1 and gives the grid 4x the blocks: with B*H = 2 the query tiles alone
// would give only 128 blocks for 132 SMs.
#include "attention_common.cuh"

extern "C" int reface_wide_attention(const void* q, const void* k,
                                     const void* v, void* o, int bh, int n,
                                     int m, int d, float scale_log2, int dtype,
                                     void* stream) {
  // d <= 128 is one slice; wider heads are cut into 128-wide slices
  const int dv = d <= 128 ? d : 128;
  if (d <= 0 || d % 8 != 0 || d % dv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return reface::launch_attn_dtype<16>(dtype, q, k, v, o, bh, n, m, d, dv,
                                       scale_log2, 0, s);
}

// The training forward (attention_common.cuh, kLse): o as above plus one fp32
// log-sum-exp per query row, with the library's rule for the row sum (fp32
// probabilities, rounded only for the PV product). The UNet's self-attention
// at 4096 and 1024 tokens (d = 40, 80) is one slice; wider heads are sliced
// as above and the first slice writes lse.
extern "C" int reface_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int bh, int n, int m, int d,
                                          float scale_log2, int dtype,
                                          void* stream) {
  if (d <= 0 || d % 8 != 0 || (d > 128 && d % 128 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  using namespace reface;
  if (d <= 48) return launch_attn_dtype<6, true>(dtype, q, k, v, o, bh, n, m, d, d, scale_log2, 0, s, l);
  if (d <= 96) return launch_attn_dtype<12, true>(dtype, q, k, v, o, bh, n, m, d, d, scale_log2, 0, s, l);
  return launch_attn_dtype<16, true>(dtype, q, k, v, o, bh, n, m, d, d <= 128 ? d : 128,
                                     scale_log2, 0, s, l);
}
