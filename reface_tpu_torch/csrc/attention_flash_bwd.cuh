// Per-warp products and tile staging shared by the flash-attention backward
// kernels: attention_flash_bwd.cu (K4/K5 at D <= 128) and
// attention_flash_bwd_wide.cu (K4/K5 at D > 128).
#pragma once

#include "attention_common.cuh"

namespace reface {

// --- per-warp products in the mma m16n8k16 fragment layout -----------------
// Thread (g = lane / 4, t = lane % 4) holds, for n-tile j of 8 columns,
// acc[j][0..1] at row g, columns 8j + 2t, 8j + 2t + 1, and acc[j][2..3] at
// row g + 8. fp32 only, in scalar FMAs: bf16 runs the Hopper kernels
// (attention_bwd_sm90.cuh, attention_bwd_wide_sm90.cuh).

// acc[j] += A B^T over a depth of kw (a multiple of 16): A is this warp's 16
// rows, row-major at `a` (stride lda); B is stored n-major at `b` (row c of b
// is column c of the product, stride ldb). Only n-tiles j < nj are computed.
template <typename T, int NJ>
__device__ __forceinline__ void mma_ss(float (&acc)[NJ][4], const T* a, int lda,
                                       const T* b, int ldb, int kw, int nj,
                                       int g, int t) {
  static_assert(sizeof(T) == 4, "fp32 only");
  for (int kk = 0; kk < kw; kk += 16) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const T* ar = a + (g + 8 * (e >> 1)) * lda + kk;
          const T* br = b + (j * 8 + 2 * t + (e & 1)) * ldb + kk;
          float s = acc[j][e];
#pragma unroll
          for (int x = 0; x < 16; ++x) s = fmaf(to_f(ar[x]), to_f(br[x]), s);
          acc[j][e] = s;
        }
      }
    }
  }
}

// acc[j] += P B^T over a depth of kBN: P is this warp's 16 x 64 tile held in
// registers (p[8][4], fragment layout), passed through the warp's
// 16 x (kBN + 4) scratch rows in shared memory; B is stored n-major at `b`
// (stride ldb).
template <typename T, int NJ>
__device__ __forceinline__ void mma_rs(float (&acc)[NJ][4], const float (&p)[8][4],
                                       float* scratch, const T* b, int ldb,
                                       int nj, int g, int t) {
  static_assert(sizeof(T) == 4, "fp32 only");
  constexpr int ss = kBN + 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      scratch[(g + 8 * (e >> 1)) * ss + j * 8 + 2 * t + (e & 1)] = p[j][e];
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j < nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* pr = scratch + (g + 8 * (e >> 1)) * ss;
        const T* br = b + (j * 8 + 2 * t + (e & 1)) * ldb;
        float s = acc[j][e];
        for (int x = 0; x < kBN; ++x) s = fmaf(pr[x], to_f(br[x]), s);
        acc[j][e] = s;
      }
    }
  }
  __syncwarp();
}

// --- tile staging ------------------------------------------------------------

// Rows [r0, r0 + 64) of a (rows, d) matrix into s (64 x w, stride ss); zero
// past `rows` and in the columns [d, w).
template <typename T>
__device__ __forceinline__ void stage_rows(T* s, int ss, const T* src, int r0,
                                           int rows, int d, int w) {
  for (int i = threadIdx.x; i < kBM * (w / 8); i += kThreads) {
    const int r = i / (w / 8), c = (i % (w / 8)) * 8;
    Vec8<T> x = (r0 + r < rows && c < d) ? load8(src + (size_t)(r0 + r) * d + c)
                                         : zero8<T>();
    store8(s + r * ss + c, x);
  }
}

// The same rows transposed: s[c][r] for c < d (a multiple of 8), r < 64.
template <typename T>
__device__ __forceinline__ void stage_rows_t(T* s, int ss, const T* src, int r0,
                                             int rows, int d) {
  for (int i = threadIdx.x; i < kBM * (d / 8); i += kThreads) {
    const int r = i / (d / 8), c = (i % (d / 8)) * 8;
    Vec8<T> x = (r0 + r < rows) ? load8(src + (size_t)(r0 + r) * d + c) : zero8<T>();
#pragma unroll
    for (int e = 0; e < 8; ++e) s[(c + e) * ss + r] = x.e[e];
  }
}

// Row strides (elements) of the row-major tiles (depth w = d rounded up to
// 16) and of the transposed tiles (64 columns), padded against bank conflicts.
template <typename T> __host__ __device__ inline int row_stride(int d) {
  return round_up(d, 16) + Pad<T>::v;
}
template <typename T> __host__ __device__ inline int t_stride() {
  return kBM + Pad<T>::v;
}

// Shared memory of a block: `rows` row-major tiles, `trans` transposed ones,
// `stats` arrays of 64 floats, and the fp32 path's per-warp scratch.
template <typename T>
inline size_t bwd_smem_bytes(int d, int rows, int trans, int stats) {
  size_t b = ((size_t)rows * kBM * row_stride<T>(d) + (size_t)trans * d * t_stride<T>()) * sizeof(T)
             + (size_t)stats * kBM * sizeof(float);
  return b + (size_t)kWarps * 16 * (kBN + 4) * sizeof(float);
}

}  // namespace reface
