// K5 on Hopper for bf16 at D > 128 (the VAE decoder's mid-block head of
// d = 512): dQ of the flash attention from what the forward saved, in two
// launches behind attention_flash_bwd_wide.cu's reface_flash_bwd_dq_wide.
// fp32 keeps that file's scalar kernel; K4 at this width is that file's too.
//
// Replaces: jax/experimental/pallas/ops/tpu/flash_attention.py:1456
// (_flash_attention_bwd_dq, :1287, body :1146-1270) at the shape
// reface_tpu/nn/vae.py:98 gives it, (B, 1, 4096, 512).
//
// Function, the library's: P = exp(scale Q K^T - lse); dS = P (dO V^T - di)
// scale, rounded to bf16 at the point where the library rounds it for the
// dQ product (ds.astype(k.dtype), :1257-1259); dQ = dS K in fp32, stored in
// bf16. The library's body can write that same rounded dS to device memory
// (ds_tile_ref, :1250-1253); this port always does, and splits the function
// there:
//   1. flash_bwd_ds_sm90: S = Q K^T and dP = dO V^T for a tile of 128
//      queries x 128 keys, then dS, rounded to bf16, into a (BH, N, Mp)
//      workspace that the caller allocates (Mp = M rounded up to 8, TMA's
//      16-byte row pitch; keys in [M, Mp) get 0);
//   2. flash_bwd_dq_gemm_sm90: dQ = dS K, batched over BH.
// Deterministic: one block writes each element of dS and of dQ once; no
// atomics.
//
// Bound on the card: the tensor cores, 3 x 2 BH N M D operations (S, dP,
// dQ: each product once) = 206 GFLOP at (4,4096,4096,512), 0.208 ms; the
// workspace adds a write and a read of 2 BH N Mp bytes (2 x 128 MiB at that
// shape, 0.08 ms at 3.35 TB/s) to the bytes, which stay below it.
//
// Why two kernels: a 64 x 512 fp32 dQ tile is 256 registers a thread for a
// warpgroup, more than ptxas grants (168), so one kernel would split D
// across blocks and recompute S and dP in each (the scalar fp32 kernel's
// design, 3x the products). The S and dP accumulators are small whatever D
// is, and the GEMM's accumulator is as wide as its output tile.
//
// Design, on the layer of attention_fwd_sm90.cuh (its TMA maps, mbarriers,
// wgmma descriptors). Both kernels: two consumer warpgroups, each owning 64
// of the block's 128 query rows, and one producer warp whose first lane
// issues every TMA load into a ring of stages (288 threads).
//   ds: the 512-deep contraction streams through the ring in 64-column
//       chunks (a stage holds the chunk of Q and dO for the block's 128
//       queries and of K and V for its 128 keys, 64 KB; 3 stages). Each
//       warpgroup runs S += Q K^T and dP += dO V^T (SS, both operands
//       K-major, m64n128k16) into 2 x 64 registers; one chunk's products
//       stay in flight while the next is issued. The epilogue forms
//       P = exp2(S scale log2e - lse2) and dS in the accumulator layout and
//       stores dS as bf16 pairs.
//   dq_gemm: the output tile is 128 queries x 128 columns of D; the
//       contraction over M runs in 64-key chunks (a stage holds the dS box
//       of 64 keys x 128 queries, K-major, and the K box of 64 keys x 128
//       columns, read MN-major through wgmma's transposed-B mode: 32 KB; 4
//       stages). Each warpgroup accumulates 64 x 128 in fp32 (64 registers).
// Ragged edges: TMA zero-fills rows past N and M and the workspace's keys
// past Mp. Queries at or past N get lse = +inf (P = 0) and are not stored;
// keys at or past M get dS = 0.
#pragma once

#include "attention_fwd_sm90.cuh"

namespace reface {
namespace sm90 {
namespace wide {

constexpr int kThreads = 288;   // two consumer warpgroups, then the producer warp
constexpr int kProducer = 256;  // the producer warp's first thread
constexpr int kRows = 128;      // queries per block, 64 per consumer warpgroup
constexpr int kBox = kRows * 128;  // a box of 128 rows x 64 bf16 columns (128 bytes)

// ------------------------------------------------------------ 1. dS

namespace ds {

constexpr int kKeys = 128;  // keys per block
constexpr int kStages = 3;
constexpr int kQOff = 0, kDOOff = kBox, kKOff = 2 * kBox, kVOff = 3 * kBox;  // in a stage
constexpr int kStageBytes = 4 * kBox;
constexpr int kBarOff = kStages * kStageBytes;
constexpr int kFull = kBarOff;
constexpr int kEmpty = kFull + 8 * kStages;
constexpr int kSmem = kEmpty + 8 * kStages + 1024;  // + alignment slack
static_assert(kKeys == kRows, "a stage's four boxes are alike");
static_assert(kSmem <= 232448, "shared memory of one block");

__device__ __forceinline__ void consume(uint32_t base, const float* __restrict__ lse,
                                        const float* __restrict__ di,
                                        __nv_bfloat16* __restrict__ ws, int n, int m, int mp,
                                        int d, float scale) {
  constexpr int kS = kKeys / 2;  // S (and dP) registers a thread
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int nchunks = d / 64;
  const size_t bh = blockIdx.z;
  const int row0 = blockIdx.y * kRows + wg * 64 + warp * 16 + g;  // and row0 + 8
  const int key0 = blockIdx.x * kKeys;
  const uint32_t rows_off = wg * 64 * 128;  // this warpgroup's 64 queries in a Q or dO box

  float sc[kS], dp[kS];
#pragma unroll
  for (int i = 0; i < kS; ++i) sc[i] = dp[i] = 0.f;
  fence_regs(sc);
  fence_regs(dp);
  for (int c = 0; c < nchunks; ++c) {
    const int s = c % kStages;
    const uint32_t st = base + s * kStageBytes;
    mbar_wait(base + kFull + 8 * s, (c / kStages) & 1);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)  // 16 columns = 32 bytes
      WgmmaSS<kKeys>::run(sc, desc_sw128(st + kQOff + rows_off + ks * 32, 16, 1024),
                          desc_sw128(st + kKOff + ks * 32, 16, 1024), 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      WgmmaSS<kKeys>::run(dp, desc_sw128(st + kDOOff + rows_off + ks * 32, 16, 1024),
                          desc_sw128(st + kVOff + ks * 32, 16, 1024), 1);
    wg_commit();
    // chunk c stays in flight; chunk c - 1 is done, and its stage free
    wg_wait<1>();
    __syncwarp();
    if (c > 0 && lane == 0) mbar_arrive(base + kEmpty + 8 * ((c - 1) % kStages));
  }
  wg_wait<0>();
  fence_regs(sc);
  fence_regs(dp);

  // dS = P (dP - di) scale with P = exp2(S scale log2e - lse2), 0 at keys
  // at or past M. This thread holds queries g (e = 0, 1) and g + 8
  // (e = 2, 3) of its warp's 16, keys 8 i + 2 tq + (e & 1) of the tile.
  const float scale_log2 = scale * kLog2ef;
  float lse2[2], dir[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < n ? lse[bh * n + row] * kLog2ef : INFINITY;
    dir[r] = row < n ? di[bh * n + row] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    __nv_bfloat16* wr = ws + (bh * n + row) * mp;
#pragma unroll
    for (int i = 0; i < kS / 4; ++i) {
      const int key = key0 + 8 * i + 2 * tq;  // mp is even: key < mp holds key + 1 < mp
      if (key >= mp) continue;
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2(fmaf(sc[4 * i + 2 * r + e], scale_log2, -lse2[r]));
        x[e] = key + e < m ? p * (dp[4 * i + 2 * r + e] - dir[r]) * scale : 0.f;
      }
      *reinterpret_cast<uint32_t*>(wr + key) = pack_bf16x2(x[0], x[1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_ds_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  __nv_bfloat16* __restrict__ ws, int n, int m, int mp, int d, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms are 1024-aligned

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(base + kFull + 8 * s, 1);
      mbar_init(base + kEmpty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kProducer) {  // the producer warp: its first lane issues every load
    if (threadIdx.x == kProducer) {
      const int k0 = blockIdx.x * kKeys, q0 = blockIdx.y * kRows, bh = blockIdx.z;
      for (int c = 0; c < d / 64; ++c) {
        const int s = c % kStages;
        const uint32_t st = base + s * kStageBytes, full = base + kFull + 8 * s;
        mbar_wait(base + kEmpty + 8 * s, ((c / kStages) & 1) ^ 1);
        mbar_expect_tx(full, kStageBytes);
        tma_load_3d(st + kQOff, &tq, full, c * 64, q0, bh);
        tma_load_3d(st + kDOOff, &tdo, full, c * 64, q0, bh);
        tma_load_3d(st + kKOff, &tk, full, c * 64, k0, bh);
        tma_load_3d(st + kVOff, &tv, full, c * 64, k0, bh);
      }
    }
  } else {
    consume(base, lse, di, ws, n, m, mp, d, scale);
  }
}

}  // namespace ds

// ------------------------------------------------------------ 2. dQ = dS K

namespace gemm {

constexpr int kCols = 128;  // columns of dQ per block, two 64-column boxes of K
constexpr int kBK = 64;     // keys per chunk of the contraction
constexpr int kStages = 4;
constexpr int kKBox = kBK * 128;              // one box of K: 64 keys x 64 columns
constexpr int kKOff = kBox;                   // in a stage: the dS box, then K's two boxes
constexpr int kStageBytes = kBox + 2 * kKBox;
constexpr int kBarOff = kStages * kStageBytes;
constexpr int kFull = kBarOff;
constexpr int kEmpty = kFull + 8 * kStages;
constexpr int kSmem = kEmpty + 8 * kStages + 1024;  // + alignment slack
static_assert(kSmem <= 232448, "shared memory of one block");

__device__ __forceinline__ void consume(uint32_t base, __nv_bfloat16* __restrict__ dq, int n,
                                        int m, int d) {
  constexpr int kO = kCols / 2;  // dQ registers a thread
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int nchunks = (m + kBK - 1) / kBK;
  const size_t bh = blockIdx.z;
  const int row0 = blockIdx.x * kRows + wg * 64 + warp * 16 + g;  // and row0 + 8
  const int col0 = blockIdx.y * kCols;

  float acc[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int c = 0; c < nchunks; ++c) {
    const int s = c % kStages;
    const uint32_t st = base + s * kStageBytes;
    mbar_wait(base + kFull + 8 * s, (c / kStages) & 1);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)  // dS: 16 keys = 32 bytes of a row; K: 16 key rows
      WgmmaSST<kCols>::run(acc, desc_sw128(st + wg * 64 * 128 + ks * 32, 16, 1024),
                           desc_sw128(st + kKOff + ks * 16 * 128, kKBox, 1024), 1);
    wg_commit();
    wg_wait<1>();  // chunk c - 1 is done, and its stage free
    __syncwarp();
    if (c > 0 && lane == 0) mbar_arrive(base + kEmpty + 8 * ((c - 1) % kStages));
  }
  wg_wait<0>();
  fence_regs(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    __nv_bfloat16* dqr = dq + (bh * n + row) * d + col0;
#pragma unroll
    for (int i = 0; i < kO / 4; ++i)
      *reinterpret_cast<uint32_t*>(dqr + 8 * i + 2 * tq) =
          pack_bf16x2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_gemm_sm90(const __grid_constant__ CUtensorMap tds,
                       const __grid_constant__ CUtensorMap tk, __nv_bfloat16* __restrict__ dq,
                       int n, int m, int d) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms are 1024-aligned

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(base + kFull + 8 * s, 1);
      mbar_init(base + kEmpty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kProducer) {  // the producer warp: its first lane issues every load
    if (threadIdx.x == kProducer) {
      const int q0 = blockIdx.x * kRows, col0 = blockIdx.y * kCols, bh = blockIdx.z;
      for (int c = 0; c < (m + kBK - 1) / kBK; ++c) {
        const int s = c % kStages;
        const uint32_t st = base + s * kStageBytes, full = base + kFull + 8 * s;
        mbar_wait(base + kEmpty + 8 * s, ((c / kStages) & 1) ^ 1);
        mbar_expect_tx(full, kStageBytes);
        tma_load_3d(st, &tds, full, c * kBK, q0, bh);
        tma_load_3d(st + kKOff, &tk, full, col0, c * kBK, bh);
        tma_load_3d(st + kKOff + kKBox, &tk, full, col0 + 64, c * kBK, bh);
      }
    }
  } else {
    consume(base, dq, n, m, d);
  }
}

}  // namespace gemm

// dQ of bf16 operands at D a multiple of 128: dS into the caller's (BH, N,
// mp) bf16 workspace, mp = M rounded up to 8, then dQ = dS K. Both launches
// on `stream`.
inline int flash_bwd_dq_wide_bf16(const void* q, const void* k, const void* v, const void* lse,
                                  const void* dout, const void* di, void* dq, void* ws, int mp,
                                  int bh, int n, int m, int d, float scale, cudaStream_t stream) {
  if (d <= 0 || d % gemm::kCols != 0 || ws == nullptr || mp < m || mp >= m + 8 || mp % 8 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo, tds, tkg;
  int rc = make_map(&tq, q, d, n, bh, kRows);
  if (rc == 0) rc = make_map(&tdo, dout, d, n, bh, kRows);
  if (rc == 0) rc = make_map(&tk, k, d, m, bh, ds::kKeys);
  if (rc == 0) rc = make_map(&tv, v, d, m, bh, ds::kKeys);
  if (rc == 0) rc = make_map(&tds, ws, mp, n, bh, kRows);
  if (rc == 0) rc = make_map(&tkg, k, d, m, bh, gemm::kBK);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(ds::flash_bwd_ds_sm90,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, ds::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm::flash_bwd_dq_gemm_sm90,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, gemm::kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_ds((m + ds::kKeys - 1) / ds::kKeys, (n + kRows - 1) / kRows, bh);
  ds::flash_bwd_ds_sm90<<<grid_ds, kThreads, ds::kSmem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<__nv_bfloat16*>(ws), n, m, mp, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_dq((n + kRows - 1) / kRows, d / gemm::kCols, bh);
  gemm::flash_bwd_dq_gemm_sm90<<<grid_dq, kThreads, gemm::kSmem, stream>>>(
      tds, tkg, static_cast<__nv_bfloat16*>(dq), n, m, d);
  return (int)cudaGetLastError();
}

}  // namespace wide
}  // namespace sm90
}  // namespace reface
