// K4 (dK, dV) and K5 (dQ) for wide heads, D > 128: the flash-attention
// backward of the VAE decoder's mid-block attention (one head of d=512 over
// 4096 tokens), which the full training loss differentiates through.
//
// Replaces: the same two library kernels as attention_flash_bwd.cu
// (jax/experimental/pallas/ops/tpu/flash_attention.py in jax 0.9.0, K4
// _flash_attention_bwd_dkv :941 / pallas_call :1121, K5
// _flash_attention_bwd_dq :1287 / :1456), at the shape
// reface_tpu/nn/vae.py:98 gives them: (B, 1, 4096, 512).
//
// Bound on the card: operations. At (BH, N, M, D) = (4, 4096, 4096, 512) K4 is
// 8*N*M*D*BH = 275 GFLOP (0.278 ms at the bf16 peak) and K5 6*N*M*D*BH =
// 206 GFLOP (0.208 ms) against ~100 MB of operands and results (K5 in bf16
// adds its dS workspace, 2 x 128 MiB written and read).
//
// Dispatch, by dtype, never as a fallback:
//   K5, bf16 -> attention_bwd_wide_sm90.cuh: dS into a (BH, N, Mp) bf16
//     workspace that the caller allocates, then dQ = dS K, two wgmma/TMA
//     kernels that run every product once (no bf16 instance of
//     flash_bwd_dq_wide_kernel is built);
//   K4 in both dtypes and K5 in fp32 -> the sliced kernels below.
//
// Design of the sliced kernels. A 64-row fp32 tile of dK and dV (or dQ) over
// all 512 columns is 128 KB a tile, more than a block's registers (256 KB for
// the whole SM), and the D <= 128 kernels' resident K/V (or Q/dO) tiles would
// not fit its shared memory beside the streamed ones. So the head dimension
// is split across blocks: a block owns one 64-row tile and one 128-column
// slice of the result (grid.y = D / 128). It recomputes S = Q K^T and
// dP = dO V^T over the full depth, streaming all four operands through
// shared memory in 128-column chunks, and runs the products that feed its
// slice (dV += P^T dO, dK += dS^T Q, or dQ += dS K) against the slice's 128
// columns only, staged transposed once per tile. Nothing is resident: K and
// V (K4) or Q and dO (K5) are re-read from L2 for every tile of the other
// sequence. The recomputation costs (2*512 + 2*128) / (4*128) = 2.5x the
// products for K4 and (2*512 + 128) / (3*128) = 3x for K5; it keeps the
// register tile of the D = 128 instance, needs no atomics (one block writes
// each element once: deterministic), and gives the grid 4x the blocks. bf16
// K4 runs its products with mma.sync m16n8k16, fp32 with scalar FMAs in
// full fp32. Numerics and masking of the ragged edges are those of
// attention_flash_bwd.cu.
#include "attention_bwd_wide_sm90.cuh"
#include "attention_flash_bwd.cuh"

namespace reface {

constexpr int kNT = kKC / 8;  // 8-wide output tiles of a 128-column slice

// Rows [r0, r0 + 64) x columns [c0, c0 + 128) of a (rows, d) matrix into s
// (64 x 128, stride ss); zero past `rows`.
template <typename T>
__device__ __forceinline__ void stage_chunk(T* s, int ss, const T* src, int r0,
                                            int rows, int d, int c0) {
  for (int i = threadIdx.x; i < kBM * kNT; i += kThreads) {
    const int r = i / kNT, c = (i % kNT) * 8;
    Vec8<T> x = (r0 + r < rows) ? load8(src + (size_t)(r0 + r) * d + c0 + c)
                                : zero8<T>();
    store8(s + r * ss + c, x);
  }
}

// The same chunk transposed: s[c][r] for c < 128, r < 64.
template <typename T>
__device__ __forceinline__ void stage_chunk_t(T* s, int ss, const T* src, int r0,
                                              int rows, int d, int c0) {
  for (int i = threadIdx.x; i < kBM * kNT; i += kThreads) {
    const int r = i / kNT, c = (i % kNT) * 8;
    Vec8<T> x = (r0 + r < rows) ? load8(src + (size_t)(r0 + r) * d + c0 + c)
                                : zero8<T>();
#pragma unroll
    for (int e = 0; e < 8; ++e) s[(c + e) * ss + r] = x.e[e];
  }
}

// Shared memory of a block: 4 row-major 64 x 128 chunks, `trans` transposed
// 128 x 64 slices, `stats` arrays of 64 floats, the fp32 per-warp scratch.
template <typename T>
inline size_t wide_smem_bytes(int trans, int stats) {
  return bwd_smem_bytes<T>(kKC, 4, trans, stats);
}

// --- K4: dK and dV, one 128-column slice -------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ lse,
                          const T* __restrict__ dout, const float* __restrict__ di,
                          T* __restrict__ dk, T* __restrict__ dv, int n, int m,
                          int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rs = row_stride<T>(kKC), ts = t_stride<T>();
  T* Ks = reinterpret_cast<T*>(smem_raw);  // one 128-column chunk of each
  T* Vs = Ks + kBN * rs;
  T* Qs = Vs + kBN * rs;
  T* Os = Qs + kBM * rs;   // dO
  T* Qt = Os + kBM * rs;   // Q^T, this block's slice
  T* Ot = Qt + kKC * ts;   // dO^T, this block's slice
  float* Ls = reinterpret_cast<float*>(Ot + kKC * ts);  // lse * log2(e), +inf past n
  float* Ds = Ls + kBM;                                  // di, 0 past n
  float* scratch = Ds + kBM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBN;
  const int s0 = blockIdx.y * kKC;
  const size_t bh = blockIdx.z;
  const T* qb = q + bh * n * d;
  const T* ob = dout + bh * n * d;
  const T* kb = k + bh * m * d;
  const T* vb = v + bh * m * d;
  const float* lb = lse + bh * n;
  const float* db = di + bh * n;
  const float scale_log2 = scale * kLog2e;
  const int wr = warp * 16;
  float* sw = scratch + warp * 16 * (kBN + 4);

  float dk_acc[kNT][4], dv_acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += kBM) {
    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 64 queries,
    // summed over the depth chunk by chunk
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    for (int c0 = 0; c0 < d; c0 += kKC) {
      __syncthreads();  // every warp is done with the previous chunk and tile
      stage_chunk(Ks, rs, kb, k0, m, d, c0);
      stage_chunk(Vs, rs, vb, k0, m, d, c0);
      stage_chunk(Qs, rs, qb, q0, n, d, c0);
      stage_chunk(Os, rs, ob, q0, n, d, c0);
      if (c0 == 0) {
        stage_chunk_t(Qt, ts, qb, q0, n, d, s0);
        stage_chunk_t(Ot, ts, ob, q0, n, d, s0);
        for (int i = tid; i < kBM; i += kThreads) {
          const bool in = q0 + i < n;
          Ls[i] = in ? lb[q0 + i] * kLog2e : INFINITY;
          Ds[i] = in ? db[q0 + i] : 0.f;
        }
      }
      __syncthreads();
      mma_ss<T, 8>(s, Ks + wr * rs, rs, Qs, rs, kKC, 8, g, t);
      mma_ss<T, 8>(dp, Vs + wr * rs, rs, Os, rs, kKC, 8, g, t);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = exp2f(s[j][e] * scale_log2 - Ls[j * 8 + 2 * t + (e & 1)]);
    }
    mma_rs<T, kNT>(dv_acc, s, sw, Ot, ts, kNT, g, t);  // dV += P^T dO
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = s[j][e] * (dp[j][e] - Ds[j * 8 + 2 * t + (e & 1)]) * scale;
    }
    mma_rs<T, kNT>(dk_acc, s, sw, Qt, ts, kNT, g, t);  // dK += dS^T Q
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + wr + g + 8 * r;
    if (key >= m) continue;
    T* dkr = dk + (bh * m + key) * d + s0;
    T* dvr = dv + (bh * m + key) * d + s0;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      dkr[j * 8 + 2 * t] = from_f<T>(dk_acc[j][2 * r]);
      dkr[j * 8 + 2 * t + 1] = from_f<T>(dk_acc[j][2 * r + 1]);
      dvr[j * 8 + 2 * t] = from_f<T>(dv_acc[j][2 * r]);
      dvr[j * 8 + 2 * t + 1] = from_f<T>(dv_acc[j][2 * r + 1]);
    }
  }
}

// --- K5: dQ, one 128-column slice --------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ lse,
                         const T* __restrict__ dout, const float* __restrict__ di,
                         T* __restrict__ dq, int n, int m, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rs = row_stride<T>(kKC), ts = t_stride<T>();
  T* Qs = reinterpret_cast<T*>(smem_raw);  // one 128-column chunk of each
  T* Os = Qs + kBM * rs;  // dO
  T* Ks = Os + kBM * rs;
  T* Vs = Ks + kBN * rs;
  T* Kt = Vs + kBN * rs;  // K^T, this block's slice
  float* scratch = reinterpret_cast<float*>(Kt + kKC * ts);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBM;
  const int s0 = blockIdx.y * kKC;
  const size_t bh = blockIdx.z;
  const T* qb = q + bh * n * d;
  const T* ob = dout + bh * n * d;
  const T* kb = k + bh * m * d;
  const T* vb = v + bh * m * d;
  const float scale_log2 = scale * kLog2e;
  const int wr = warp * 16;
  float* sw = scratch + warp * 16 * (kBN + 4);

  float lse2[2], dir[2];  // this thread's rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    lse2[r] = row < n ? lse[bh * n + row] * kLog2e : INFINITY;
    dir[r] = row < n ? di[bh * n + row] : 0.f;
  }

  float dq_acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.f;

  for (int k0 = 0; k0 < m; k0 += kBN) {
    // S = Q K^T and dP = dO V^T for this warp's 16 queries x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    for (int c0 = 0; c0 < d; c0 += kKC) {
      __syncthreads();  // every warp is done with the previous chunk and tile
      stage_chunk(Qs, rs, qb, q0, n, d, c0);
      stage_chunk(Os, rs, ob, q0, n, d, c0);
      stage_chunk(Ks, rs, kb, k0, m, d, c0);
      stage_chunk(Vs, rs, vb, k0, m, d, c0);
      if (c0 == 0) stage_chunk_t(Kt, ts, kb, k0, m, d, s0);
      __syncthreads();
      mma_ss<T, 8>(s, Qs + wr * rs, rs, Ks, rs, kKC, 8, g, t);
      mma_ss<T, 8>(dp, Os + wr * rs, rs, Vs, rs, kKC, 8, g, t);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const float p = key < m ? exp2f(s[j][e] * scale_log2 - lse2[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - dir[e >> 1]) * scale;  // dS
      }
    }
    mma_rs<T, kNT>(dq_acc, s, sw, Kt, ts, kNT, g, t);  // dQ += dS K
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    if (row >= n) continue;
    T* dqr = dq + (bh * n + row) * d + s0;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      dqr[j * 8 + 2 * t] = from_f<T>(dq_acc[j][2 * r]);
      dqr[j * 8 + 2 * t + 1] = from_f<T>(dq_acc[j][2 * r + 1]);
    }
  }
}

template <typename T>
inline int launch_dkv_wide(const void* q, const void* k, const void* v,
                           const void* lse, const void* dout, const void* di,
                           void* dk, void* dv, int bh, int n, int m, int d,
                           float scale, cudaStream_t stream) {
  const size_t smem = wide_smem_bytes<T>(2, 2);
  auto kern = flash_bwd_dkv_wide_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + kBN - 1) / kBN, d / kKC, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<const float*>(di), static_cast<T*>(dk), static_cast<T*>(dv),
      n, m, d, scale);
  return (int)cudaGetLastError();
}

template <typename T>
inline int launch_dq_wide(const void* q, const void* k, const void* v,
                          const void* lse, const void* dout, const void* di,
                          void* dq, int bh, int n, int m, int d, float scale,
                          cudaStream_t stream) {
  const size_t smem = wide_smem_bytes<T>(1, 0);
  auto kern = flash_bwd_dq_wide_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kBM - 1) / kBM, d / kKC, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<const float*>(di), static_cast<T*>(dq), n, m, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace reface

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the results); lse and
// di are fp32 (BH, N). D must be a multiple of 128; batch*heads at most 65535.
extern "C" int reface_flash_bwd_dkv_wide(const void* q, const void* k,
                                         const void* v, const void* lse,
                                         const void* dout, const void* di,
                                         void* dk, void* dv, int bh, int n,
                                         int m, int d, float scale, int dtype,
                                         void* stream) {
  if (d <= 0 || d % reface::kKC != 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return reface::launch_dkv_wide<__nv_bfloat16>(q, k, v, lse, dout, di, dk, dv,
                                                  bh, n, m, d, scale, s);
  if (dtype == 0)
    return reface::launch_dkv_wide<float>(q, k, v, lse, dout, di, dk, dv, bh, n,
                                          m, d, scale, s);
  return (int)cudaErrorInvalidValue;
}

// ws: the bf16 dS workspace that bf16 K5 writes and reads, (BH, N, ws_pitch)
// contiguous with ws_pitch = M rounded up to 8; the caller allocates it
// (fp32 takes nullptr).
extern "C" int reface_flash_bwd_dq_wide(const void* q, const void* k,
                                        const void* v, const void* lse,
                                        const void* dout, const void* di,
                                        void* dq, void* ws, int ws_pitch, int bh, int n,
                                        int m, int d, float scale, int dtype, void* stream) {
  if (d <= 0 || d % reface::kKC != 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return reface::sm90::wide::flash_bwd_dq_wide_bf16(q, k, v, lse, dout, di, dq, ws, ws_pitch,
                                                      bh, n, m, d, scale, s);
  if (dtype == 0)
    return reface::launch_dq_wide<float>(q, k, v, lse, dout, di, dq, bh, n, m,
                                         d, scale, s);
  return (int)cudaErrorInvalidValue;
}
