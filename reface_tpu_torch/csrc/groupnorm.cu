// K3: GroupNorm(32) with optional SiLU, NCHW, fp32 statistics, one launch a
// call.
//
// Replaces: reface_tpu/ops/groupnorm.py:_kernel (its pallas_call at :80).
// That kernel holds one sample's (HW, C) block in VMEM, sums x and x^2 per
// channel, forms each group's mean and E[x^2] - mean^2 through a one-hot
// matmul, and normalises, applies the affine and the SiLU in the same pass:
// one read and one write, the group kept on chip between its statistics and
// the apply. It runs only where the fp32 working set fits 4 MB of VMEM
// (:72-73); above that the JAX package takes _reference_impl, the two-pass
// variance. This kernel computes the two-pass (Chan) variance at every size:
// E[x^2] - mean^2 cancels when |mean| >> std.
//
// Bound on the card: bytes, 2 x numel x itemsize + 8C (x read once, y
// written once, the fp32 scale and bias), against about 10 fp32 operations
// an element.
//
// Design. In NCHW, group g of sample b is one contiguous run of
// L = (C/G) H W elements. One thread-block cluster of n CTAs (n = 1, 2, 4
// or 8, a runtime launch attribute) takes a group; CTA r owns the slice
// [r S, min(L, (r+1) S)), S a multiple of 8 elements, so that every slice is
// 16-byte aligned and a multiple of 16 bytes. The wrapper picks n, S and the
// path from L (ops/groupnorm.py::cluster_plan):
//
//   resident (every shape of the fused UNet up to 1024 px in bf16: a slice
//     of at most kSliceBytes): thread 0 brings the slice into shared memory
//     with cp.async.bulk copies of kChunkBytes, each completing on its own
//     mbarrier, so the sum over the first chunk starts while the rest land.
//     The slice's mean is taken over shared memory, then its sum of squared
//     deviations about that mean; normalise, affine and SiLU read shared
//     memory and store 16-byte vectors. x is read from HBM once.
//   streaming (a group above 8 x kSliceBytes, e.g. a fused UNet at 1024 px
//     in fp32, (2,960,128,128), or the VAE decoder's 512 x 512 level,
//     (1,128,512,512)): each thread merges the exact count, mean and M2 of
//     its 8-element vectors with Chan's formula in one read, the block
//     merges its threads' in a fixed order, and the apply reads the slice
//     again, from the 50 MB L2.
//
// The apply is where the arithmetic is: the SiLU's two special-function
// operations an element (ex2 and rcp, 16 a clock on each SM) take about half
// as long as the bytes at the largest shapes, so it uses the approximate
// __expf and __fdividef (errors of a few ulp at the magnitudes a normalised
// activation takes, far inside the fp32 check's 1e-4) and not expf and an
// IEEE division, whose range reduction, Newton steps and slow-path branch
// add several times the SiLU's own instructions.
//
// Each CTA then leaves its slice's mean and M2 in its own shared memory and
// arrives at the cluster barrier; thread 0 of every CTA reads the n partials
// through distributed shared memory (mapa, ld.shared::cluster) and merges
// them with Chan's formula in rank order, so every CTA holds bit-identical
// mean and rstd and two calls give the same bits (no atomics). A second
// cluster barrier, arrived after the merge and waited before exit, keeps
// each CTA's partials alive until the whole cluster has read them. No
// scratch buffer, no second launch.
//
// ptxas (-Xptxas -v, printed per instance by chip_smoke.py phase 1): 32-38
// registers, no spills; shared memory per CTA: the slice (dynamic, at most
// kSliceBytes) and 256 bytes of mbarriers, partials and block sums (128 in
// the streaming instances).
#include <math.h>

#include "common.cuh"

namespace {

using namespace reface;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // the portable cluster size
// A resident slice's dynamic shared memory: the 227 KB a block may use, less
// the static arrays. ops/groupnorm.py::SLICE_BYTES mirrors it.
constexpr int kSliceBytes = 224 * 1024;
constexpr int kChunkBytes = 16 * 1024;  // one bulk copy and its mbarrier
constexpr int kMaxChunks = kSliceBytes / kChunkBytes;

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster arrives (release: its earlier
// writes become visible) and later waits (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The float at `p` in the shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// `bytes` (a multiple of 16) from global `src` to this CTA's shared `dst`,
// completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Sum over the block; every thread gets the same bits.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// Chan's merge of the (count, mean, M2) of a second set into the first's.
__device__ __forceinline__ void chan(float& n, float& mean, float& m2, float nb, float meanb,
                                     float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb, d = meanb - mean;
  mean += d * (nb / nn);
  m2 += m2b + d * d * (n * nb / nn);
  n = nn;
}

// Chan's merge over the block, in a fixed order (lanes by a tree, then the
// warps in turn); every thread gets the same bits.
__device__ void block_chan(float& n, float& mean, float& m2, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, n, o);
    const float mb = __shfl_down_sync(0xffffffffu, mean, o);
    const float qb = __shfl_down_sync(0xffffffffu, m2, o);
    chan(n, mean, m2, nb, mb, qb);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[3 * warp] = n;
    red[3 * warp + 1] = mean;
    red[3 * warp + 2] = m2;
  }
  __syncthreads();
  n = mean = m2 = 0.f;
  for (int w = 0; w < kWarps; ++w) chan(n, mean, m2, red[3 * w], red[3 * w + 1], red[3 * w + 2]);
}

template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads)
group_norm_sm90(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, T* __restrict__ y, int L, int S, int hw,
                int cg, int groups, float eps, int silu) {
  extern __shared__ __align__(128) unsigned char slice[];
  __shared__ __align__(8) uint64_t bars[kMaxChunks];
  __shared__ float red[3 * kWarps];
  __shared__ float part[2];   // this slice's mean and M2, read by the whole cluster
  __shared__ float stats[2];  // the group's mean and rstd

  const uint32_t n = cluster_size(), rank = cluster_rank();
  const int grp = (int)cluster_id();
  const int beg = (int)rank * S, len = min(S, L - beg), nvec = len / 8;
  const size_t base = (size_t)grp * L + beg;
  const Vec8<T>* sv = reinterpret_cast<const Vec8<T>*>(slice);

  float mean, m2;
  if constexpr (kResident) {
    const int bytes = len * (int)sizeof(T);
    const int chunks = (bytes + kChunkBytes - 1) / kChunkBytes;
    if (threadIdx.x == 0) {
      for (int k = 0; k < chunks; ++k) mbar_init(smem_u32(&bars[k]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      const unsigned char* src = reinterpret_cast<const unsigned char*>(x + base);
      for (int k = 0; k < chunks; ++k) {
        const int off = k * kChunkBytes, nb = min(kChunkBytes, bytes - off);
        mbar_expect_tx(smem_u32(&bars[k]), nb);
        bulk_load(smem_u32(slice + off), src + off, nb, smem_u32(&bars[k]));
      }
    }
    __syncthreads();  // the barriers are initialised
    constexpr int kChunkVecs = kChunkBytes / (int)sizeof(Vec8<T>);
    float acc = 0.f;
    for (int k = 0; k < chunks; ++k) {
      mbar_wait(smem_u32(&bars[k]), 0);
      const int end = min(nvec, (k + 1) * kChunkVecs);
      for (int v = k * kChunkVecs + threadIdx.x; v < end; v += kThreads) {
        const Vec8<T> e = sv[v];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc += to_f(e.e[i]);
      }
    }
    mean = block_sum(acc, red) / (float)len;
    float dev = 0.f;
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      const Vec8<T> e = sv[v];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float z = to_f(e.e[i]) - mean;
        dev = fmaf(z, z, dev);
      }
    }
    m2 = block_sum(dev, red);
  } else {
    float cnt = 0.f;
    mean = m2 = 0.f;
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      const Vec8<T> e = load8(x + base + 8 * v);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) s += to_f(e.e[i]);
      const float m8 = s * 0.125f;
      float q8 = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float z = to_f(e.e[i]) - m8;
        q8 = fmaf(z, z, q8);
      }
      chan(cnt, mean, m2, 8.f, m8, q8);
    }
    block_chan(cnt, mean, m2, red);
  }

  // The cluster's merge, in rank order, by thread 0 of every CTA.
  if (threadIdx.x == 0) {
    part[0] = mean;
    part[1] = m2;
  }
  cluster_arrive();
  cluster_wait();
  if (threadIdx.x == 0) {
    float gm = 0.f;
    for (uint32_t r = 0; r < n; ++r)
      gm += (float)min(S, L - (int)r * S) * ld_cluster(&part[0], r);
    gm /= (float)L;
    float gq = 0.f;
    for (uint32_t r = 0; r < n; ++r) {
      const float d = ld_cluster(&part[0], r) - gm;
      gq += ld_cluster(&part[1], r) + (float)min(S, L - (int)r * S) * d * d;
    }
    stats[0] = gm;
    stats[1] = rsqrtf(gq / (float)L + eps);
  }
  cluster_arrive();  // this CTA has read the others' partials
  __syncthreads();

  const float gm = stats[0], rstd = stats[1];
  const int ch0 = (grp % groups) * cg;
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    Vec8<T> e;
    if constexpr (kResident) e = sv[v];
    else e = load8(x + base + 8 * v);
    const int ch = ch0 + (beg + 8 * v) / hw;  // hw % 8 == 0: a vector never straddles channels
    const float sc = scale[ch], bi = bias[ch];
    Vec8<T> out;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float z = (to_f(e.e[i]) - gm) * rstd;
      z = z * sc + bi;
      if (silu) z = __fdividef(z, 1.f + __expf(-z));
      out.e[i] = from_f<T>(z);
    }
    store8(y + base + 8 * v, out);
  }
  cluster_wait();  // no CTA leaves while another may still read its partials
}

template <typename T, bool kResident>
int launch(const void* x, const void* scale, const void* bias, void* y, int b, int c, int hw,
           int groups, float eps, int silu, int n, int S, cudaStream_t stream) {
  auto kernel = group_norm_sm90<T, kResident>;
  if constexpr (kResident) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSliceBytes);
    if (attr != cudaSuccess) return (int)attr;
  }
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = n;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * groups * n);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kResident ? S * sizeof(T) : 0;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const int cg = c / groups;
  return (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                                 static_cast<const float*>(scale),
                                 static_cast<const float*>(bias), static_cast<T*>(y),
                                 cg * hw, S, hw, cg, groups, eps, silu);
}

template <typename T>
int dispatch(const void* x, const void* scale, const void* bias, void* y, int b, int c,
             int hw, int groups, float eps, int silu, int n, int S, int resident,
             cudaStream_t stream) {
  if (resident) {
    if ((long long)S * sizeof(T) > kSliceBytes) return (int)cudaErrorInvalidValue;
    return launch<T, true>(x, scale, bias, y, b, c, hw, groups, eps, silu, n, S, stream);
  }
  return launch<T, false>(x, scale, bias, y, b, c, hw, groups, eps, silu, n, S, stream);
}

}  // namespace

// x, y: (B, C, H*W) contiguous, 16-byte aligned; scale, bias: (C,) fp32.
// dtype: 0 fp32, 1 bf16. The plan (ops/groupnorm.py::cluster_plan): a
// cluster of `cluster` CTAs (1, 2, 4 or 8) per group, each a slice of
// `slice` elements (a multiple of 8; the last CTA's may be shorter, never
// empty), `resident` if the slice is held in shared memory.
extern "C" int reface_group_norm(const void* x, const void* scale, const void* bias, void* y,
                                 int b, int c, int hw, int groups, float eps, int silu,
                                 int dtype, int cluster, int slice, int resident,
                                 void* stream) {
  if (b <= 0 || groups <= 0 || c % groups != 0 || hw <= 0 || hw % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const long long L = (long long)(c / groups) * hw;
  if (L > (1ll << 30) || cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      slice <= 0 || slice % 8 != 0 || (long long)slice * cluster < L ||
      (long long)slice * (cluster - 1) >= L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, scale, bias, y, b, c, hw, groups, eps, silu, cluster,
                                   slice, resident, s);
  if (dtype == 0)
    return dispatch<float>(x, scale, bias, y, b, c, hw, groups, eps, silu, cluster, slice,
                           resident, s);
  return (int)cudaErrorInvalidValue;
}
