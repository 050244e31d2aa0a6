// Streaming (online-softmax) attention forward shared by the small-head
// self-attention kernel (attention_smalld.cu) and the wide-head kernel
// (attention_wide.cu). Plain C interface; built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
//
// One block = 4 warps = 64 query rows of one (batch*head) and one slice of
// the output's head dimension [s0, s0+dv). Each warp owns 16 query rows and
// streams 64-key tiles: S = Q K^T over the full head dim (K read in chunks of
// at most 128 columns through shared memory), an online row max, then
// P V for the warp's rows and the block's output slice. Scores, row sums
// and the output accumulator are fp32.
//
// Callers: K1 (attention_smalld.cu) in fp32, and in bf16 only at
// 128 < D <= 256, and K2 / K2 with residuals (attention_wide.cu) in fp32
// only; bf16 K1 at D <= 128 and bf16 K2 run the Hopper kernel of
// attention_fwd_sm90.cuh.
//
// kLse = false is close to K1's rule, that of reface_tpu/ops/attention_smalld.py:
// probabilities are exp2 of the log2e-folded scores, rounded to the input
// dtype before the PV product, and the row sum is taken over those same
// rounded values (the TPU kernel's ones-column). The running max replaces
// the TPU kernel's first-256-key shift; softmax is shift-invariant, so both
// are exact up to where the bf16 rounding of p happens (in fp32, exact up to
// summation order). fast=1 drops the shift entirely.
//
// kLse = true is the library flash_attention's rule: the row sum takes the
// fp32 probabilities, which are rounded to the input dtype only for the PV
// product, and each query row's log-sum-exp (natural log, fp32) is written
// to `lse` for the backward kernels (attention_flash_bwd.cu). In fp32 the
// rounding is a no-op, so fp32 K2 (kLse = false) computes the library's
// function too.
//
// bf16 runs its products on the tensor cores with mma.sync m16n8k16
// (fp32 accumulate). fp32 computes the same fragments with scalar FMAs, in
// full fp32, so the card can hold the kernel to the plain version tightly.
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
template <> struct Pad<__nv_bfloat16> { static constexpr int v = 8; };
template <> struct Pad<float> { static constexpr int v = 4; };

template <typename T>
__device__ __forceinline__ Vec8<T> zero8() {
  Vec8<T> r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.e[i] = from_f<T>(0.f);
  return r;
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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
  if (sizeof(T) == 4) bytes += (size_t)kWarps * 16 * (kBN + 4) * sizeof(float);  // P
  return bytes;
}

// NT = number of 8-wide output tiles the accumulator can hold (>= dv/8).
template <typename T, int NT, bool kLse>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
                float* __restrict__ lse, int n, int m, int d, int dv,
                float scale_log2, int fast) {
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

  for (int k0 = 0; k0 < m; k0 += kBN) {
    float s[8][4];
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
        if constexpr (sizeof(T) == 2) {
          const T* qa = Qs + (wr + g) * qs + c0 + kk + 2 * t;
          uint32_t a0 = ld_u32(qa), a1 = ld_u32(qa + 8 * qs);
          uint32_t a2 = ld_u32(qa + 8), a3 = ld_u32(qa + 8 * qs + 8);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const T* kp = Ks + (j * 8 + g) * ks + kk + 2 * t;
            mma_bf16(s[j], a0, a1, a2, a3, ld_u32(kp), ld_u32(kp + 8));
          }
        } else {
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
    }

    // online softmax over this tile; rows g (e=0,1) and g+8 (e=2,3)
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

    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < nt) {
            const T* vp = Vt + (j * 8 + g) * vs + kk * 16 + 2 * t;
            mma_bf16(acc[j], a0, a1, a2, a3, ld_u32(vp), ld_u32(vp + 8));
          }
        }
      }
    } else {
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
