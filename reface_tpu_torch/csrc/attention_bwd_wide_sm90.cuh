// K4 and K5 on Hopper for bf16 at D > 128 (the VAE decoder's mid-block head
// of d = 512, and any width the flash path pads to a multiple of 128): dK,
// dV and dQ of the flash attention from what the forward saved, in three
// launches behind attention_flash_bwd_wide.cu's entry points. fp32 keeps
// that file's scalar kernels.
//
// Replaces: jax/experimental/pallas/ops/tpu/flash_attention.py:1121
// (_flash_attention_bwd_dkv, :941, body :894-919) and :1456
// (_flash_attention_bwd_dq, :1287, body :1146-1270) at the shape
// reface_tpu/nn/vae.py:98 gives them, (B, 1, 4096, 512).
//
// Function, the library's: P = exp(scale Q K^T - lse); dS = P (dO V^T - di)
// scale; dV = P^T dO with P rounded to bf16 (p.astype(do.dtype)), dK =
// dS^T Q and dQ = dS K with dS rounded to bf16 (ds.astype(q.dtype),
// :1251-1259), all in fp32, stored in bf16. K4 and K5 round the same dS at
// the same place, and the library's dQ body can write it to device memory
// (ds_tile_ref, :1250-1253); this port always does, and splits the function
// there:
//   1. flash_bwd_ds_sm90: S = Q K^T and dP = dO V^T for a tile of 128
//      queries x 128 keys, then dS and P, rounded to bf16, into two
//      (BH, N, Mp) workspaces that the caller allocates (Mp = M rounded up
//      to 8, TMA's 16-byte row pitch; keys in [M, Mp) get 0; P only when
//      its workspace is given);
//   2. flash_bwd_dq_gemm_sm90: dQ = dS K (K5), batched over BH;
//   3. flash_bwd_dkv_gemm_sm90: dV = P^T dO and dK = dS^T Q (K4), one
//      launch over {dV, dK} x column tiles x key tiles x BH.
// ops/attention.py::flash_attention_bwd runs launch 1 once, inside K5's
// wrapper, and both GEMMs read its workspaces; K4's wrapper alone runs
// launch 1 itself. Deterministic: one block writes each element of dS, P,
// dQ, dK and dV once; no atomics.
//
// Bound on the card: the tensor cores, 5 x 2 BH N M D operations (S, dP,
// dQ, dV, dK: each product once) = 344 GFLOP at (4,4096,4096,512), 0.347 ms;
// the workspaces add dS written once and read twice and P written once and
// read once, 5 x 2 BH N Mp bytes (5 x 128 MiB at that shape, 0.20 ms at 3.35
// TB/s), below it.
//
// Why split: a 64 x 512 fp32 dQ (or dK, dV) tile is 256 registers a thread
// for a warpgroup, more than ptxas grants (168), so one kernel would split D
// across blocks and recompute S and dP in each (the scalar fp32 kernels'
// design: 3x the products for dQ, 2.5x for dK and dV). The S and dP
// accumulators are small whatever D is, and a GEMM's accumulator is as wide
// as its output tile.
//
// Design, on the layer of attention_fwd_sm90.cuh (its TMA maps, mbarriers,
// wgmma descriptors). All three kernels: two consumer warpgroups, each
// owning 64 of the block's 128 output rows, and one producer warp whose
// first lane issues every TMA load into a ring of stages (288 threads).
//   ds: the 512-deep contraction streams through the ring in 64-column
//       chunks (a stage holds the chunk of Q and dO for the block's 128
//       queries and of K and V for its 128 keys, 64 KB; 3 stages). Each
//       warpgroup runs S += Q K^T and dP += dO V^T (SS, both operands
//       K-major, m64n128k16) into 2 x 64 registers; one chunk's products
//       stay in flight while the next is issued. The epilogue forms
//       P = exp2(S scale log2e - lse2) and dS in the accumulator layout and
//       stores both as bf16 pairs.
//   dq_gemm: the output tile is 128 queries x 128 columns of D; the
//       contraction over M runs in 64-key chunks (a stage holds the dS box
//       of 64 keys x 128 queries, K-major, and the K box of 64 keys x 128
//       columns, read MN-major through wgmma's transposed-B mode: 32 KB; 4
//       stages). Each warpgroup accumulates 64 x 128 in fp32 (64 registers).
//   dkv_gemm: the output tile is 128 keys x 128 columns of D; the
//       contraction over N runs in 64-query chunks. P^T and dS^T are read
//       as they lie in the workspaces, (queries, keys) with the keys
//       contiguous, and Q and dO as they lie, (queries, D): both operands
//       are MN-major, which wgmma reads through its transposed-A and
//       transposed-B modes (WgmmaSSTT) for 16-bit operands in shared
//       memory, so nothing is transposed by hand or written twice. A stage
//       holds two 64-key boxes of the workspace and two 64-column boxes of
//       Q or dO for 64 queries: 32 KB; 4 stages. Each warpgroup accumulates
//       its 64 keys x 128 columns in fp32 (64 registers). Column tiles of
//       one key tile are neighbours in the grid, so the workspace strip
//       they share is read once from device memory and again from L2.
// Ragged edges: TMA zero-fills rows past N and M and the workspaces' keys
// past Mp. Queries at or past N get lse = +inf (P = 0) and are not stored;
// keys at or past M get dS = P = 0.
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
                                        __nv_bfloat16* __restrict__ ws,
                                        __nv_bfloat16* __restrict__ wp, int n, int m, int mp,
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

  // dS = P (dP - di) scale with P = exp2(S scale log2e - lse2); both 0 at
  // keys at or past M. This thread holds queries g (e = 0, 1) and g + 8
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
    const size_t off = (bh * n + row) * mp;
#pragma unroll
    for (int i = 0; i < kS / 4; ++i) {
      const int key = key0 + 8 * i + 2 * tq;  // mp is even: key < mp holds key + 1 < mp
      if (key >= mp) continue;
      float x[2], y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = key + e < m;
        const float p = ex2(fmaf(sc[4 * i + 2 * r + e], scale_log2, -lse2[r]));
        x[e] = in ? p * (dp[4 * i + 2 * r + e] - dir[r]) * scale : 0.f;
        y[e] = in ? p : 0.f;
      }
      *reinterpret_cast<uint32_t*>(ws + off + key) = pack_bf16x2(x[0], x[1]);
      if (wp != nullptr) *reinterpret_cast<uint32_t*>(wp + off + key) = pack_bf16x2(y[0], y[1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_ds_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  __nv_bfloat16* __restrict__ ws, __nv_bfloat16* __restrict__ wp, int n, int m,
                  int mp, int d, float scale) {
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
    consume(base, lse, di, ws, wp, n, m, mp, d, scale);
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

// ------------------------------------------------------------ 3. dV = P^T dO, dK = dS^T Q

namespace dkv {

constexpr int kCols = 128;          // columns of dK or dV per block
constexpr int kBQ = 64;             // queries per chunk of the contraction
constexpr int kStages = 4;
constexpr int kHalf = kBQ * 128;    // one box: 64 queries x 64 keys (or 64 columns of D), 8 KB
constexpr int kBOff = 2 * kHalf;    // in a stage: the workspace's two key boxes, then Q's or dO's
constexpr int kStageBytes = 4 * kHalf;
constexpr int kBarOff = kStages * kStageBytes;
constexpr int kFull = kBarOff;
constexpr int kEmpty = kFull + 8 * kStages;
constexpr int kSmem = kEmpty + 8 * kStages + 1024;  // + alignment slack
static_assert(kSmem <= 232448, "shared memory of one block");

__device__ __forceinline__ void consume(uint32_t base, __nv_bfloat16* __restrict__ out, int n,
                                        int m, int d, int key0, int col0) {
  constexpr int kO = kCols / 2;  // output registers a thread
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int nchunks = (n + kBQ - 1) / kBQ;
  const int row0 = key0 + wg * 64 + warp * 16 + g;  // and row0 + 8

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
    for (int ks = 0; ks < kBQ / 16; ++ks)  // 16 queries = 16 rows of both boxes
      WgmmaSSTT<kCols>::run(acc, desc_sw128(st + wg * kHalf + ks * 16 * 128, kHalf, 1024),
                            desc_sw128(st + kBOff + ks * 16 * 128, kHalf, 1024), 1);
    wg_commit();
    wg_wait<1>();  // chunk c - 1 is done, and its stage free
    __syncwarp();
    if (c > 0 && lane == 0) mbar_arrive(base + kEmpty + 8 * ((c - 1) % kStages));
  }
  wg_wait<0>();
  fence_regs(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = row0 + 8 * r;
    if (key >= m) continue;
    __nv_bfloat16* orow = out + (size_t)key * d + col0;
#pragma unroll
    for (int i = 0; i < kO / 4; ++i)
      *reinterpret_cast<uint32_t*>(orow + 8 * i + 2 * tq) =
          pack_bf16x2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
  }
}

// grid: x = {dV, dK} x column tiles (dV's first), y = key tiles, z = BH
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_gemm_sm90(const __grid_constant__ CUtensorMap tp,
                        const __grid_constant__ CUtensorMap tds,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tq, __nv_bfloat16* __restrict__ dv,
                        __nv_bfloat16* __restrict__ dk, int n, int m, int d) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms are 1024-aligned
  const int tiles = d / kCols;
  const bool is_dk = blockIdx.x >= tiles;
  const int col0 = (blockIdx.x % tiles) * kCols, key0 = blockIdx.y * kRows, bh = blockIdx.z;

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
      const CUtensorMap* ta = is_dk ? &tds : &tp;  // (queries, keys)
      const CUtensorMap* tb = is_dk ? &tq : &tdo;  // (queries, D)
      for (int c = 0; c < (n + kBQ - 1) / kBQ; ++c) {
        const int s = c % kStages;
        const uint32_t st = base + s * kStageBytes, full = base + kFull + 8 * s;
        mbar_wait(base + kEmpty + 8 * s, ((c / kStages) & 1) ^ 1);
        mbar_expect_tx(full, kStageBytes);
        tma_load_3d(st, ta, full, key0, c * kBQ, bh);
        tma_load_3d(st + kHalf, ta, full, key0 + 64, c * kBQ, bh);
        tma_load_3d(st + kBOff, tb, full, col0, c * kBQ, bh);
        tma_load_3d(st + kBOff + kHalf, tb, full, col0 + 64, c * kBQ, bh);
      }
    }
  } else {
    consume(base, (is_dk ? dk : dv) + (size_t)bh * m * d, n, m, d, key0, col0);
  }
}

}  // namespace dkv

// The host side for bf16 operands at D a multiple of 128; `ws` (dS) and `wp`
// (P) are the caller's (BH, N, mp) bf16 workspaces, mp = M rounded up to 8.
// Each launches on `stream`.

inline bool wide_args_ok(int d, const void* ws, int m, int mp) {
  return d > 0 && d % gemm::kCols == 0 && ws != nullptr && mp >= m && mp < m + 8 && mp % 8 == 0;
}

// 1. dS (and P when wp is not nullptr) into the workspaces
inline int flash_bwd_ds_bf16(const void* q, const void* k, const void* v, const void* lse,
                             const void* dout, const void* di, void* ws, void* wp, int mp, int bh,
                             int n, int m, int d, float scale, cudaStream_t stream) {
  if (!wide_args_ok(d, ws, m, mp)) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  int rc = make_map(&tq, q, d, n, bh, kRows);
  if (rc == 0) rc = make_map(&tdo, dout, d, n, bh, kRows);
  if (rc == 0) rc = make_map(&tk, k, d, m, bh, ds::kKeys);
  if (rc == 0) rc = make_map(&tv, v, d, m, bh, ds::kKeys);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(ds::flash_bwd_ds_sm90,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, ds::kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + ds::kKeys - 1) / ds::kKeys, (n + kRows - 1) / kRows, bh);
  ds::flash_bwd_ds_sm90<<<grid, kThreads, ds::kSmem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<__nv_bfloat16*>(ws), static_cast<__nv_bfloat16*>(wp), n, m, mp, d, scale);
  return (int)cudaGetLastError();
}

// 2. dQ = dS K from the filled dS workspace
inline int flash_bwd_dq_gemm_bf16(const void* k, void* dq, const void* ws, int mp, int bh, int n,
                                  int m, int d, cudaStream_t stream) {
  if (!wide_args_ok(d, ws, m, mp)) return (int)cudaErrorInvalidValue;
  CUtensorMap tds, tk;
  int rc = make_map(&tds, ws, mp, n, bh, kRows);
  if (rc == 0) rc = make_map(&tk, k, d, m, bh, gemm::kBK);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(gemm::flash_bwd_dq_gemm_sm90,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, gemm::kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kRows - 1) / kRows, d / gemm::kCols, bh);
  gemm::flash_bwd_dq_gemm_sm90<<<grid, kThreads, gemm::kSmem, stream>>>(
      tds, tk, static_cast<__nv_bfloat16*>(dq), n, m, d);
  return (int)cudaGetLastError();
}

// 3. dV = P^T dO and dK = dS^T Q from the filled workspaces, one launch
inline int flash_bwd_dkv_gemm_bf16(const void* q, const void* dout, void* dk, void* dv,
                                   const void* ws, const void* wp, int mp, int bh, int n, int m,
                                   int d, cudaStream_t stream) {
  if (!wide_args_ok(d, ws, m, mp) || wp == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap tp, tds, tdo, tq;
  int rc = make_map(&tp, wp, mp, n, bh, dkv::kBQ);
  if (rc == 0) rc = make_map(&tds, ws, mp, n, bh, dkv::kBQ);
  if (rc == 0) rc = make_map(&tdo, dout, d, n, bh, dkv::kBQ);
  if (rc == 0) rc = make_map(&tq, q, d, n, bh, dkv::kBQ);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(dkv::flash_bwd_dkv_gemm_sm90,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dkv::kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(2 * (d / dkv::kCols), (m + kRows - 1) / kRows, bh);
  dkv::flash_bwd_dkv_gemm_sm90<<<grid, kThreads, dkv::kSmem, stream>>>(
      tp, tds, tdo, tq, static_cast<__nv_bfloat16*>(dv), static_cast<__nv_bfloat16*>(dk), n, m,
      d);
  return (int)cudaGetLastError();
}

}  // namespace wide
}  // namespace sm90
}  // namespace reface
