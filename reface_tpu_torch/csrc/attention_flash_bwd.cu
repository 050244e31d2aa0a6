// K4 (dK, dV) and K5 (dQ): the flash-attention backward of the UNet's
// self-attention in training (8 heads of d=40 over 4096 tokens and of d=80
// over 1024 tokens, batch*heads = 32 at batch 4).
//
// Replaces: the two backward kernels of the library flash_attention that
// reface_tpu/ops/attention.py:_flash_attention calls under jax.grad
// (jax/experimental/pallas/ops/tpu/flash_attention.py in jax 0.9.0):
//   K4 _flash_attention_bwd_dkv (:941, pallas_call at :1121),
//   K5 _flash_attention_bwd_dq  (:1287, pallas_call at :1456).
// Both read what the forward saved (attention_wide.cu, reface_flash_attention_fwd):
// o's row statistic lse (fp32, natural log) and, through the wrapper,
// di = sum(o * dO, -1) in fp32 (flash_attention.py:273 computes it outside
// any kernel too).
//
// Bound on the card: operations. K4 recomputes S = Q K^T and runs dV += P^T
// dO, dP = dO V^T and dK += dS^T Q: 8*N*M*D flops per (batch*head); K5
// recomputes S and dP and runs dQ += dS K: 6*N*M*D. At (BH, N, D) =
// (32, 4096, 40) that is 172 and 129 GFLOP against ~13 MB of operands and
// results, far above the card's ~295 bf16 flop/byte ridge.
//
// Dispatch, by dtype, never as a fallback: bf16 dK/dV runs the Hopper kernel
// of attention_bwd_sm90.cuh (wgmma, TMA, a producer warp; no bf16 instance
// of flash_bwd_dkv_kernel is built); fp32 dK/dV and both dtypes of dQ run
// the kernels below.
//
// Design. The library splits the backward into a dK/dV kernel and a dQ kernel
// so that neither needs atomics; so does this port, and both are
// deterministic. A TPU grid walks its last axis in order and carries dK/dV
// (or dQ) in scratch from one step to the next; here one block owns one
// 64-row tile of the result and loops over the other sequence itself:
//   K4 (fp32 here; bf16 in attention_bwd_sm90.cuh, 128 keys a block): one
//       block per 64-key tile and (batch*head), K and V resident in
//       shared memory, looping over 64-query tiles of Q, dO, lse and di;
//   K5: one block per 64-query tile and (batch*head), Q and dO resident,
//       looping over 64-key tiles of K and V.
// Each of the 4 warps owns 16 rows of the block's tile. bf16 runs every
// product on the tensor cores with mma.sync m16n8k16 (fp32 accumulate); P and
// dS stay in registers between products, in the accumulator layout, which is
// the next product's A-fragment layout (as in the forward's PV). They are
// rounded to the input dtype only for the product that reads them, as the
// library does (P^T for dV, dS for dK and dQ; flash_attention.py:900,918,
// 1261). Every product takes its B operand k-contiguous from shared memory, so
// Q, dO (K4) and K (K5) are also staged transposed. fp32 runs the same
// fragments with scalar FMAs in full fp32, so the card can hold the kernels
// to the plain version tightly. D is a multiple of 8 up to 128 (no pad to 128
// as on the TPU; the QK^T depth is padded to 16 in shared memory only). The
// ragged edges are masked: queries past N get lse = +inf, so P = 0; keys past M
// get P = 0 in K5 and are not stored by K4. Simple and right first: no TMA,
// no wgmma, no pipelining of the tile loads (K5 in bf16 still runs so). Wider heads (the VAE decoder's
// d=512) run the sliced kernels of attention_flash_bwd_wide.cu; the per-warp
// products and the tile staging both files use are in attention_flash_bwd.cuh.
#include "attention_bwd_sm90.cuh"
#include "attention_flash_bwd.cuh"

namespace reface {

// --- K4: dK and dV -----------------------------------------------------------
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ lse,
                     const T* __restrict__ dout, const float* __restrict__ di,
                     T* __restrict__ dk, T* __restrict__ dv, int n, int m, int d,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = round_up(d, 16), rs = row_stride<T>(d), ts = t_stride<T>();
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kBN * rs;
  T* Qs = Vs + kBN * rs;
  T* Os = Qs + kBM * rs;  // dO
  T* Qt = Os + kBM * rs;  // Q^T
  T* Ot = Qt + d * ts;    // dO^T
  float* Ls = reinterpret_cast<float*>(Ot + d * ts);  // lse * log2(e), +inf past n
  float* Ds = Ls + kBM;                                // di, 0 past n
  float* scratch = Ds + kBM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBN;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * n * d;
  const T* ob = dout + bh * n * d;
  const float* lb = lse + bh * n;
  const float* db = di + bh * n;
  const float scale_log2 = scale * kLog2e;
  const int nt = d / 8, wr = warp * 16;
  float* sw = scratch + warp * 16 * (kBN + 4);

  stage_rows(Ks, rs, k + bh * m * d, k0, m, d, w);
  stage_rows(Vs, rs, v + bh * m * d, k0, m, d, w);

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += kBM) {
    __syncthreads();  // every warp is done with the previous query tile
    stage_rows(Qs, rs, qb, q0, n, d, w);
    stage_rows(Os, rs, ob, q0, n, d, w);
    stage_rows_t(Qt, ts, qb, q0, n, d);
    stage_rows_t(Ot, ts, ob, q0, n, d);
    for (int i = tid; i < kBM; i += kThreads) {
      const bool in = q0 + i < n;
      Ls[i] = in ? lb[q0 + i] * kLog2e : INFINITY;
      Ds[i] = in ? db[q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T for this warp's 16 keys x 64 queries, then P^T
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_ss<T, 8>(s, Ks + wr * rs, rs, Qs, rs, w, 8, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = exp2f(s[j][e] * scale_log2 - Ls[j * 8 + 2 * t + (e & 1)]);
    }
    mma_rs<T, NT>(dv_acc, s, sw, Ot, ts, nt, g, t);  // dV += P^T dO

    // dP^T = V dO^T, then dS^T = P^T (dP^T - di) scale
    float dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    mma_ss<T, 8>(dp, Vs + wr * rs, rs, Os, rs, w, 8, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = s[j][e] * (dp[j][e] - Ds[j * 8 + 2 * t + (e & 1)]) * scale;
    }
    mma_rs<T, NT>(dk_acc, s, sw, Qt, ts, nt, g, t);  // dK += dS^T Q
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + wr + g + 8 * r;
    if (key >= m) continue;
    T* dkr = dk + (bh * m + key) * d;
    T* dvr = dv + (bh * m + key) * d;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        dkr[j * 8 + 2 * t] = from_f<T>(dk_acc[j][2 * r]);
        dkr[j * 8 + 2 * t + 1] = from_f<T>(dk_acc[j][2 * r + 1]);
        dvr[j * 8 + 2 * t] = from_f<T>(dv_acc[j][2 * r]);
        dvr[j * 8 + 2 * t + 1] = from_f<T>(dv_acc[j][2 * r + 1]);
      }
    }
  }
}

// --- K5: dQ ------------------------------------------------------------------
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ lse,
                    const T* __restrict__ dout, const float* __restrict__ di,
                    T* __restrict__ dq, int n, int m, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = round_up(d, 16), rs = row_stride<T>(d), ts = t_stride<T>();
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Os = Qs + kBM * rs;  // dO
  T* Ks = Os + kBM * rs;
  T* Vs = Ks + kBN * rs;
  T* Kt = Vs + kBN * rs;  // K^T
  float* scratch = reinterpret_cast<float*>(Kt + d * ts);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBM;
  const size_t bh = blockIdx.y;
  const T* kb = k + bh * m * d;
  const T* vb = v + bh * m * d;
  const float scale_log2 = scale * kLog2e;
  const int nt = d / 8, wr = warp * 16;
  float* sw = scratch + warp * 16 * (kBN + 4);

  stage_rows(Qs, rs, q + bh * n * d, q0, n, d, w);
  stage_rows(Os, rs, dout + bh * n * d, q0, n, d, w);
  float lse2[2], dir[2];  // this thread's rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    lse2[r] = row < n ? lse[bh * n + row] * kLog2e : INFINITY;
    dir[r] = row < n ? di[bh * n + row] : 0.f;
  }

  float dq_acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.f;

  for (int k0 = 0; k0 < m; k0 += kBN) {
    __syncthreads();  // every warp is done with the previous key tile
    stage_rows(Ks, rs, kb, k0, m, d, w);
    stage_rows(Vs, rs, vb, k0, m, d, w);
    stage_rows_t(Kt, ts, kb, k0, m, d);
    __syncthreads();

    // S = Q K^T for this warp's 16 queries x 64 keys, then P (0 past m)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_ss<T, 8>(s, Qs + wr * rs, rs, Ks, rs, w, 8, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        s[j][e] = key < m ? exp2f(s[j][e] * scale_log2 - lse2[e >> 1]) : 0.f;
      }
    }
    // dP = dO V^T, then dS = P (dP - di) scale
    float dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    mma_ss<T, 8>(dp, Os + wr * rs, rs, Vs, rs, w, 8, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s[j][e] * (dp[j][e] - dir[e >> 1]) * scale;
    }
    mma_rs<T, NT>(dq_acc, s, sw, Kt, ts, nt, g, t);  // dQ += dS K
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    if (row >= n) continue;
    T* dqr = dq + (bh * n + row) * d;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        dqr[j * 8 + 2 * t] = from_f<T>(dq_acc[j][2 * r]);
        dqr[j * 8 + 2 * t + 1] = from_f<T>(dq_acc[j][2 * r + 1]);
      }
    }
  }
}

template <typename T, int NT>
inline int launch_dkv(const void* q, const void* k, const void* v, const void* lse,
                      const void* dout, const void* di, void* dk, void* dv,
                      int bh, int n, int m, int d, float scale, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<T>(d, 4, 2, 2);
  auto kern = flash_bwd_dkv_kernel<T, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + kBN - 1) / kBN, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<const float*>(di), static_cast<T*>(dk), static_cast<T*>(dv),
      n, m, d, scale);
  return (int)cudaGetLastError();
}

template <typename T, int NT>
inline int launch_dq(const void* q, const void* k, const void* v, const void* lse,
                     const void* dout, const void* di, void* dq, int bh, int n,
                     int m, int d, float scale, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<T>(d, 4, 1, 0);
  auto kern = flash_bwd_dq_kernel<T, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kBM - 1) / kBM, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<const float*>(di), static_cast<T*>(dq), n, m, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace reface

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the results); lse and
// di are fp32 (BH, N). D must be a multiple of 8 up to 128.
#define REFACE_BWD_CHECK()                                                    \
  if (d <= 0 || d > 128 || d % 8 != 0) return (int)cudaErrorInvalidValue;     \
  cudaStream_t s = static_cast<cudaStream_t>(stream);                         \
  using namespace reface

#define REFACE_BWD_FP32(LAUNCH, ...)                                          \
  do {                                                                        \
    if (d <= 48) return LAUNCH<float, 6>(__VA_ARGS__, s);                     \
    if (d <= 96) return LAUNCH<float, 12>(__VA_ARGS__, s);                    \
    return LAUNCH<float, 16>(__VA_ARGS__, s);                                 \
  } while (0)

extern "C" int reface_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* lse, const void* dout,
                                    const void* di, void* dk, void* dv, int bh,
                                    int n, int m, int d, float scale, int dtype,
                                    void* stream) {
  REFACE_BWD_CHECK();
  if (dtype == 1)
    return sm90::flash_bwd_dkv_bf16(q, k, v, lse, dout, di, dk, dv, bh, n, m, d, scale, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  REFACE_BWD_FP32(launch_dkv, q, k, v, lse, dout, di, dk, dv, bh, n, m, d, scale);
}

extern "C" int reface_flash_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* lse, const void* dout,
                                   const void* di, void* dq, int bh, int n,
                                   int m, int d, float scale, int dtype,
                                   void* stream) {
  REFACE_BWD_CHECK();
  if (dtype == 1) {
    if (d <= 48) return launch_dq<__nv_bfloat16, 6>(q, k, v, lse, dout, di, dq, bh, n, m, d, scale, s);
    if (d <= 96) return launch_dq<__nv_bfloat16, 12>(q, k, v, lse, dout, di, dq, bh, n, m, d, scale, s);
    return launch_dq<__nv_bfloat16, 16>(q, k, v, lse, dout, di, dq, bh, n, m, d, scale, s);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  REFACE_BWD_FP32(launch_dq, q, k, v, lse, dout, di, dq, bh, n, m, d, scale);
}
