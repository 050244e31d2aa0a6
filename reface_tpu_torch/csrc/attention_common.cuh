// Streaming attention forward shared by the small-head self-attention kernel
// (attention_smalld.cu) and the wide-head kernel (attention_wide.cu). Plain
// C interface; built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
//
// One block = 4 warps = 64 query rows of one (batch*head) and one slice of
// the output's head dimension [s0, s0+dv). Each warp owns 16 query rows and
// streams 64-key tiles: S = Q K^T over the full head dim (K read in chunks of
// at most 128 columns through shared memory), the row shift, then P V for
// the warp's rows and the block's output slice. Scores, row sums and the
// output accumulator are fp32.
//
// Callers, in fp32 only: K1 (attention_smalld.cu) and K2 / K2 with
// residuals (attention_wide.cu); every bf16 call runs the Hopper kernel of
// attention_fwd_sm90.cuh.
//
// Two rules, by template option:
//   kLse = false (fp32 K1, fp32 K2): a running row max, p rounded to the
//     input dtype (a no-op in fp32) and summed as rounded. In fp32 every
//     shift is exact up to summation order, so this is K1's function and
//     the library's; fast=1 drops the shift entirely.
//   kLse = true: the library flash_attention's rule: the row sum takes the
//     fp32 probabilities, which are rounded to the input dtype only for the
//     PV product, and each query row's log-sum-exp (natural log, fp32) is
//     written to `lse` for the backward kernels (attention_flash_bwd.cu).
//
// fp32 only: scalar FMAs in full fp32 over the m16n8k16 fragment layout, so
// that the card can hold the kernel to the plain version tightly; bf16 runs
// the Hopper kernels.
#pragma once

#include <math.h>

#include "common.cuh"

namespace reface {

constexpr int kBM = 64;     // query rows per block
constexpr int kBN = 64;     // keys per tile
constexpr int kKC = 128;    // widest K chunk held in shared memory
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T> struct Pad;  // row padding (elements) against bank conflicts
template <> struct Pad<float> { static constexpr int v = 4; };

template <typename T>
__device__ __forceinline__ Vec8<T> zero8() {
  Vec8<T> r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.e[i] = from_f<T>(0.f);
  return r;
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared-memory bytes for one block (must match the carve-up in the kernel).
template <typename T>
inline size_t attn_smem_bytes(int d, int dv) {
  const int p = Pad<T>::v;
  const int dp = round_up(d, 16);
  size_t n = (size_t)kBM * (dp + p)               // Q tile, whole head dim
             + (size_t)kBN * (kKC + p)            // one K chunk
             + (size_t)round_up(dv, 8) * (kBN + p);  // V^T slice
  size_t bytes = n * sizeof(T);
  return bytes + (size_t)kWarps * 16 * (kBN + 4) * sizeof(float);  // P
}

// NT = number of 8-wide output tiles the accumulator can hold (>= dv/8).
template <typename T, int NT, bool kLse>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
                float* __restrict__ lse, int n, int m, int d, int dv,
                float scale_log2, int fast) {
  static_assert(sizeof(T) == 4, "bf16 runs the Hopper kernel of attention_fwd_sm90.cuh");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int p = Pad<T>::v;
  const int dp = round_up(d, 16);
  const int qs = dp + p, ks = kKC + p, vs = kBN + p;
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kBM * qs;
  T* Vt = Ks + kBN * ks;
  float* Ps = reinterpret_cast<float*>(Vt + round_up(dv, 8) * vs);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBM;
  const int s0 = blockIdx.y * dv;
  const size_t bh = blockIdx.z;
  const T* qb = q + bh * n * d;
  const T* kb = k + bh * m * d;
  const T* vb = v + bh * m * d;
  T* ob = o + bh * n * d;
  const int nt = dv / 8;

  // Q tile, zero-padded to dp columns and past the last row.
  for (int i = tid; i < kBM * (dp / 8); i += kThreads) {
    int r = i / (dp / 8), c = (i % (dp / 8)) * 8;
    Vec8<T> x = (q0 + r < n && c < d) ? load8(qb + (size_t)(q0 + r) * d + c) : zero8<T>();
    store8(Qs + r * qs + c, x);
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};
  const int wr = warp * 16;  // first row of this warp inside the tile

  // s = Q K^T for the key tile at k0 (unscaled), over the full head dim; the
  // tile's V^T slice is staged beside it for the PV product.
  auto tile_scores = [&](float (&s)[8][4], int k0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;

    for (int c0 = 0; c0 < dp; c0 += kKC) {
      const int kw = min(kKC, dp - c0);
      __syncthreads();  // every warp is done with the previous Ks / Vt
      for (int i = tid; i < kBN * (kw / 8); i += kThreads) {
        int r = i / (kw / 8), c = (i % (kw / 8)) * 8;
        Vec8<T> x = (k0 + r < m && c0 + c < d)
                        ? load8(kb + (size_t)(k0 + r) * d + c0 + c) : zero8<T>();
        store8(Ks + r * ks + c, x);
      }
      if (c0 == 0) {
        for (int i = tid; i < kBN * nt; i += kThreads) {
          int r = i / nt, c = (i % nt) * 8;
          Vec8<T> x = (k0 + r < m) ? load8(vb + (size_t)(k0 + r) * d + s0 + c) : zero8<T>();
#pragma unroll
          for (int e = 0; e < 8; ++e) Vt[(c + e) * vs + r] = x.e[e];
        }
      }
      __syncthreads();

      for (int kk = 0; kk < kw; kk += 16) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const T* qr = Qs + (wr + g + 8 * (e >> 1)) * qs + c0 + kk;
            const T* kr = Ks + (j * 8 + 2 * t + (e & 1)) * ks + kk;
            float a = s[j][e];
#pragma unroll
            for (int x = 0; x < 16; ++x) a = fmaf(to_f(qr[x]), to_f(kr[x]), a);
            s[j][e] = a;
          }
        }
      }
    }
  };

  for (int k0 = 0; k0 < m; k0 += kBN) {
    float s[8][4];
    tile_scores(s, k0);

    // the softmax of this tile; rows g (e=0,1) and g+8 (e=2,3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          int key = k0 + j * 8 + 2 * t + (e & 1);
          float val = key < m ? s[j][e] * scale_log2 : -INFINITY;
          s[j][e] = val;
          mx = fmaxf(mx, val);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fast ? 0.f : fmaxf(row_max[r], mx);
      const float alpha = fast ? 1.f : exp2f(row_max[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          float pr = exp2f(s[j][e] - m_new);
          if constexpr (!kLse) pr = to_f(from_f<T>(pr));  // rounded as PV sees it
          s[j][e] = pr;
          sum += pr;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      row_sum[r] = row_sum[r] * alpha + sum;
      row_max[r] = m_new;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }

    float* pw = Ps + warp * 16 * (kBN + 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pw[(g + 8 * (e >> 1)) * (kBN + 4) + j * 8 + 2 * t + (e & 1)] = s[j][e];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* pr = pw + (g + 8 * (e >> 1)) * (kBN + 4);
          const T* vr = Vt + (j * 8 + 2 * t + (e & 1)) * vs;
          float a = acc[j][e];
          for (int x = 0; x < kBN; ++x) a = fmaf(pr[x], to_f(vr[x]), a);
          acc[j][e] = a;
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    if (row >= n) continue;
    const float inv = 1.f / row_sum[r];
    if constexpr (kLse) {
      if (blockIdx.y == 0 && t == 0)
        lse[bh * n + row] = (row_max[r] + log2f(row_sum[r])) * kLn2;
    }
    T* orow = ob + (size_t)row * d + s0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        orow[j * 8 + 2 * t] = from_f<T>(acc[j][2 * r] * inv);
        orow[j * 8 + 2 * t + 1] = from_f<T>(acc[j][2 * r + 1] * inv);
      }
    }
  }
}

template <typename T, int NT, bool kLse>
inline int launch_attn(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int n, int m, int d, int dv,
                       float scale_log2, int fast, cudaStream_t stream) {
  const size_t smem = attn_smem_bytes<T>(d, dv);
  auto kern = attn_fwd_kernel<T, NT, kLse>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kBM - 1) / kBM, d / dv, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, n, m, d, dv,
      scale_log2, fast);
  return (int)cudaGetLastError();
}

}  // namespace reface
