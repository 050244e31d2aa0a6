// Element helpers shared by the port's kernels: fp32 <-> working dtype
// conversion and 8-element vector loads and stores (16 bytes of bf16, 32 of
// fp32). Callers keep every vector access 16-byte aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace reface {

// K1's row shift spans the scores of the first kShiftKeys keys
// (reface_tpu/ops/attention_smalld.py:_shift), in both of its kernels.
constexpr int kShiftKeys = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> struct alignas(16) Vec8 { T e[8]; };

template <typename T>
__device__ __forceinline__ Vec8<T> load8(const T* p) {
  Vec8<T> r;
  const uint4* s = reinterpret_cast<const uint4*>(p);
  uint4* d = reinterpret_cast<uint4*>(r.e);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(Vec8<T>) / 16); ++i) d[i] = s[i];
  return r;
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const Vec8<T>& v) {
  uint4* d = reinterpret_cast<uint4*>(p);
  const uint4* s = reinterpret_cast<const uint4*>(v.e);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(Vec8<T>) / 16); ++i) d[i] = s[i];
}

}  // namespace reface
