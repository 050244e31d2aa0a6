// Helpers shared by the port's kernels: fp32 <-> working dtype conversion,
// 8-element vector loads and stores (16 bytes of bf16, 32 of fp32; callers
// keep every vector access 16-byte aligned) and the mbarrier operations of
// the Hopper kernels.
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers and tiles are addressed by their 32-bit shared-window address.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed. A wait of more
// than 2^34 clocks (about 10 s) means a load that never lands: trap, so that
// the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

}  // namespace reface
