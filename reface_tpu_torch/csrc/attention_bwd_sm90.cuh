// K4 and K5 on Hopper for bf16 at D <= 128: the flash-attention backward of
// the UNet's self-attention from what the forward saved.
// attention_flash_bwd.cu's reface_flash_bwd_dkv and reface_flash_bwd_dq
// dispatch bf16 here; fp32 keeps that file's scalar kernels, and the VAE
// decoder's d = 512 runs attention_flash_bwd_wide.cu (K5 in bf16 through
// attention_bwd_wide_sm90.cuh).
//
// Replaces: jax/experimental/pallas/ops/tpu/flash_attention.py:1121
// (_flash_attention_bwd_dkv, :941) and :1456 (_flash_attention_bwd_dq,
// :1287, body :1146-1270), which the library's custom VJP runs under
// jax.grad of reface_tpu/ops/attention.py:_flash_attention.
//
// Function, the library's (flash_attention.py:880-918, 1240-1262):
// P = exp(scale Q K^T - lse) from the saved lse (here exp2 of log2e-scaled
// scores and lse); dP = dO V^T in fp32; dS = P (dP - di) scale;
// K4: dV += P^T dO with P^T rounded to bf16, dK += dS^T Q with dS^T rounded
// to bf16; K5: dQ += dS K with dS rounded to bf16 (ds.astype(k.dtype),
// :1257-1259). fp32 accumulation; results stored in bf16. Deterministic:
// one block owns each output tile and loops over the other sequence; no
// atomics.
//
// Bound on the card: the tensor cores. K4 runs four products of 2 BH N M D
// operations, K5 three (S and dP recomputed, then dQ): 0.278 and 0.208 ms
// a (32,4096,4096,40) call at the padded width of 64, against 0.138 ms of
// exp2s each.
//
// Design: FlashAttention-3's backward split in two kernels, on the layer
// that attention_fwd_sm90.cuh built (its TMA maps, mbarriers and wgmma
// descriptors). A block is two consumer warpgroups and one producer warp
// (288 threads). Each consumer warpgroup owns 64 of the block's 128 rows of
// the resident sequence; tiles of the other stream through a ring of 4
// stages, loaded by TMA.
//
// K4 (namespace bwd): K and V resident (128 keys a block), tiles of kBQ =
// 64 queries of Q and dO, with their lse and di, streamed. For each tile,
// each warpgroup runs
//   S^T  = K Q^T     SS, both operands K-major (D contiguous)
//   dP^T = V dO^T    SS, both K-major
//   dV  += P^T dO    RS: P^T from registers, dO read MN-major (the
//                    transposed-B mode, as the forward reads V)
//   dK  += dS^T Q    RS: dS^T from registers, Q read MN-major
// P^T and dS^T are built in registers in the accumulator layout of S^T,
// which is the A fragment of the two RS products; every product runs once
// per tile (above D = 64, S^T and dP^T once per column block, below). lse
// and di run along the columns of S^T: the producer warp stages them in
// shared memory beside each tile, lse already in log2 units, and each
// consumer thread reads the pairs of its fragment's columns. The producer's
// 32 lanes write them and arrive on the stage's "full" barrier (count 32),
// lane 0 with the tile's TMA bytes.
//
// K5 (namespace dq): Q and dO resident (128 queries a block), tiles of
// kBK = 64 keys of K and V streamed. lse (in log2 units) and di run along
// the rows of S: each consumer thread keeps its two rows' pairs in
// registers. For each tile, each warpgroup runs
//   S   = Q K^T      SS, both K-major
//   dP  = dO V^T     SS, both K-major
//   dQ += dS K       RS: dS from registers, K read MN-major through the
//                    transposed-B mode: the same K tile in shared memory as
//                    for S, through a second descriptor
// P = exp2(S scale log2e - lse2) and dS = P (dP - di) scale are built in
// registers in the accumulator layout of S, which is the A fragment of the
// RS product. dQ's accumulator is 64 x 64 at D <= 64 and 64 x 128 above (an
// MN-major operand is read in whole 64-column swizzle atoms; TMA zero-fills
// K's columns past D): 32 or 64 registers a thread, beside 2 x 32 of S and
// dP, so D = 80 runs in one block with no column split. At
// (32,1024,1024,80) the grid is 8 x 32 = 256 blocks of 128 queries for 132
// SMs (one block an SM: 1.94 waves); 64-query blocks would make 3.9 waves
// and read every K and V tile twice as often.
//
// Ragged edges: TMA zero-fills rows past N and M. A zero-filled lse would
// give P = exp2(0) = 1, so queries at or past N get lse = +inf (P = 0,
// dS = 0) and are not stored; keys at or past M (K4: not stored) give
// S = 0, not -inf, so K5 sets their P to 0.
//
// Registers: a kernel with wgmma gets at most 168 a thread from ptxas
// whether it has 288 threads or 384 (it allocates by warpgroup). K4's dV
// and dK accumulators at 128 columns (D = 80) are 128 of them, and with S^T
// and dP^T that spilled (the first design, even at 32-query tiles). So
// every K4 block accumulates 64 columns of dK and dV (2 x 32 registers, S^T
// and dP^T 2 x 32, no spills): at 64 < D <= 128 the grid has two blocks per
// key tile (blockIdx.z = which 64 columns), each of which computes S^T,
// dP^T and P over the full depth: 576 multiply-adds a score at D = 80 in
// place of 416 (38% more), and twice the exp2s, in place of spills. The
// k-steps of S (S^T) and dP (dP^T) are template constants. fence_regs and
// fence_frags pin each operand's writes before its wgmma.fence; without
// them ptxas injected fences of its own and serialised the wgmmas (notes
// C7519, C7520). Two of FlashAttention-3's overlaps were measured in each
// kernel and left out (PERF.md): issuing the next tile's first products
// before the last one's wait (K4: ptxas then serialises for lack of
// registers, C7512; K5: the writes of P and dS into the accumulators of
// products in flight serialise them, C7515) and the two warpgroups'
// ping-pong; all were slower at (32,4096,4096,40). K5's first k-step of S
// and dP overwrites the accumulator (scale-d = 0) instead of zeroing it.
#pragma once

#include "attention_fwd_sm90.cuh"

namespace reface {
namespace sm90 {
namespace bwd {

constexpr int kThreads = 288;   // two consumer warpgroups, then the producer warp
constexpr int kProducer = 256;  // the producer warp's first thread
constexpr int kKeys = 128;      // keys per block, 64 per consumer warpgroup
constexpr int kStages = 4;

constexpr int kBQ = 64;  // queries per tile

// kBoxes: 64-column boxes of the head dim (1 at D <= 64, 2 up to 128).
template <int kBoxes>
struct Cfg {
  static constexpr int kKVBox = kKeys * 128;        // one 64-column box of K or V
  static constexpr int kKVBytes = kBoxes * kKVBox;
  static constexpr int kQBox = kBQ * 128;           // one box of a Q or dO tile
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKOff = 0;
  static constexpr int kVOff = kKVBytes;
  static constexpr int kQOff = 2 * kKVBytes;        // stage s: Q tile, then dO tile
  static constexpr int kStageBytes = 2 * kQBytes;
  static constexpr int kRowOff = kQOff + kStages * kStageBytes;  // stage s: lse2[kBQ], di[kBQ]
  static constexpr int kBarOff = kRowOff + kStages * 2 * kBQ * 4;
  static constexpr int kKVFull = kBarOff;
  static constexpr int kFull = kBarOff + 8;
  static constexpr int kEmpty = kFull + 8 * kStages;
  static constexpr int kSmem = kEmpty + 8 * kStages + 1024;  // + alignment slack
  static_assert(kBoxes == 1 || kBoxes == 2, "head dims up to 128");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// kKS: the 16-column k-steps of S^T and dP^T, over the full depth.
template <int kBoxes, int kKS>
__device__ __forceinline__ void consume(uint32_t base, __nv_bfloat16* __restrict__ dk,
                                        __nv_bfloat16* __restrict__ dv, int n, int m, int d,
                                        float scale) {
  using C = Cfg<kBoxes>;
  constexpr int kS = kBQ / 2;  // S^T (and dP^T) registers a thread
  constexpr int kO = 32;       // dK (and dV) registers a thread: 64 columns
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int ntiles = (n + kBQ - 1) / kBQ;
  const float scale_log2 = scale * kLog2ef;
  const uint32_t k_addr = base + C::kKOff + wg * 64 * 128;  // this warpgroup's 64 keys
  const uint32_t v_addr = base + C::kVOff + wg * 64 * 128;
  const int half = blockIdx.z;  // which 64 columns of dK and dV this block sums

  float dk_acc[kO], dv_acc[kO], st[kS], dpt[kS];
  uint32_t pp[kBQ / 16][4], pd[kBQ / 16][4];  // P^T and dS^T in bf16, the A operands
#pragma unroll
  for (int i = 0; i < kO; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  fence_regs(dk_acc);
  fence_regs(dv_acc);

  mbar_wait(base + C::kKVFull, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % kStages;
    const uint32_t q_addr = base + C::kQOff + s * C::kStageBytes;
    const uint32_t do_addr = q_addr + C::kQBytes;
    const float* rows = reinterpret_cast<const float*>(
        __cvta_shared_to_generic(base + C::kRowOff + s * 2 * kBQ * 4));
#pragma unroll
    for (int i = 0; i < kS; ++i) st[i] = dpt[i] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    mbar_wait(base + C::kFull + 8 * s, (j / kStages) & 1);

    // S^T = K Q^T, then dP^T = V dO^T: two groups, waited for one by one
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const uint32_t off = (ks >> 2) * C::kKVBox + (ks & 3) * 32;  // 16 columns = 32 bytes
      const uint32_t qoff = (ks >> 2) * C::kQBox + (ks & 3) * 32;
      WgmmaSS<kBQ>::run(st, desc_sw128(k_addr + off, 16, 1024), desc_sw128(q_addr + qoff, 16, 1024), 1);
    }
    wg_commit();
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const uint32_t off = (ks >> 2) * C::kKVBox + (ks & 3) * 32;
      const uint32_t qoff = (ks >> 2) * C::kQBox + (ks & 3) * 32;
      WgmmaSS<kBQ>::run(dpt, desc_sw128(v_addr + off, 16, 1024), desc_sw128(do_addr + qoff, 16, 1024), 1);
    }
    wg_commit();

    // P^T = exp2(S^T scale log2e - lse2) in place. This thread holds keys
    // (rows) 16 warp + g (e = 0, 1) and + 8 (e = 2, 3), queries (columns)
    // 8 c + 2 tq + (e & 1).
    wg_wait<1>();
    fence_regs(st);
#pragma unroll
    for (int c = 0; c < kBQ / 8; ++c) {
      const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * c + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[4 * c + e] = ex2(fmaf(st[4 * c + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
    }
    // k-step kk of the RS products covers query columns 16 kk .. 16 kk + 15
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x) pp[kk][x] = pack_bf16x2(st[8 * kk + 2 * x], st[8 * kk + 2 * x + 1]);
    }
    fence_frags(pp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)  // dV += P^T dO
      WgmmaRS<64>::run(dv_acc, pp[kk], desc_sw128(do_addr + half * C::kQBox + kk * 16 * 128, 0, 1024));
    wg_commit();

    // dS^T = P^T (dP^T - di) scale
    wg_wait<1>();
    fence_regs(dpt);
#pragma unroll
    for (int c = 0; c < kBQ / 8; ++c) {
      const float2 di2 = *reinterpret_cast<const float2*>(rows + kBQ + 8 * c + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * c + e] = st[4 * c + e] * (dpt[4 * c + e] - ((e & 1) ? di2.y : di2.x)) * scale;
    }
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x) pd[kk][x] = pack_bf16x2(dpt[8 * kk + 2 * x], dpt[8 * kk + 2 * x + 1]);
    }
    fence_frags(pd);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)  // dK += dS^T Q
      WgmmaRS<64>::run(dk_acc, pd[kk], desc_sw128(q_addr + half * C::kQBox + kk * 16 * 128, 0, 1024));
    wg_commit();
    wg_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(base + C::kEmpty + 8 * s);  // stage s is free
  }

  // epilogue: this block's real columns of this warpgroup's keys below M, in bf16
  const size_t bh = blockIdx.y;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = blockIdx.x * kKeys + wg * 64 + warp * 16 + g + 8 * r;
    if (key >= m) continue;
    __nv_bfloat16* dkr = dk + (bh * m + key) * d;
    __nv_bfloat16* dvr = dv + (bh * m + key) * d;
#pragma unroll
    for (int i = 0; i < kO / 4; ++i) {
      const int c = half * 64 + 8 * i + 2 * tq;
      if (c < d) {
        *reinterpret_cast<uint32_t*>(dkr + c) = pack_bf16x2(dk_acc[4 * i + 2 * r], dk_acc[4 * i + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dvr + c) = pack_bf16x2(dv_acc[4 * i + 2 * r], dv_acc[4 * i + 2 * r + 1]);
      }
    }
  }
}

template <int kBoxes, int kKS>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse, const float* __restrict__ di,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int n, int m,
                   int d, float scale) {
  using C = Cfg<kBoxes>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms are 1024-aligned

  if (threadIdx.x == 0) {
    mbar_init(base + C::kKVFull, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(base + C::kFull + 8 * s, 32);  // every producer lane, lane 0 with the bytes
      mbar_init(base + C::kEmpty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kProducer) {  // the producer warp
    const int lane = threadIdx.x - kProducer;
    const int k0 = blockIdx.x * kKeys, bh = blockIdx.y;
    const int ntiles = (n + kBQ - 1) / kBQ;
    if (lane == 0) {
      mbar_expect_tx(base + C::kKVFull, 2 * C::kKVBytes);
      for (int c = 0; c < kBoxes; ++c) {
        tma_load_3d(base + C::kKOff + c * C::kKVBox, &tk, base + C::kKVFull, c * 64, k0, bh);
        tma_load_3d(base + C::kVOff + c * C::kKVBox, &tv, base + C::kKVFull, c * 64, k0, bh);
      }
    }
    const float* lse_bh = lse + (size_t)bh * n;
    const float* di_bh = di + (size_t)bh * n;
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % kStages;
      mbar_wait(base + C::kEmpty + 8 * s, ((j / kStages) & 1) ^ 1);
      float* rows = reinterpret_cast<float*>(
          __cvta_shared_to_generic(base + C::kRowOff + s * 2 * kBQ * 4));
      for (int i = lane; i < kBQ; i += 32) {
        const int q = j * kBQ + i;
        rows[i] = q < n ? lse_bh[q] * kLog2ef : INFINITY;  // P = 0 past N
        rows[kBQ + i] = q < n ? di_bh[q] : 0.f;
      }
      const uint32_t full = base + C::kFull + 8 * s;
      if (lane == 0) {
        const uint32_t q_addr = base + C::kQOff + s * C::kStageBytes;
        mbar_expect_tx(full, 2 * C::kQBytes);
        for (int c = 0; c < kBoxes; ++c) {
          tma_load_3d(q_addr + c * C::kQBox, &tq, full, c * 64, j * kBQ, bh);
          tma_load_3d(q_addr + C::kQBytes + c * C::kQBox, &tdo, full, c * 64, j * kBQ, bh);
        }
      } else {
        mbar_arrive(full);
      }
    }
  } else {
    consume<kBoxes, kKS>(base, dk, dv, n, m, d, scale);
  }
}

template <int kBoxes, int kKS>
inline int launch_dkv(const void* q, const void* k, const void* v, const float* lse,
                      const void* dout, const float* di, void* dk, void* dv, int bh, int n,
                      int m, int d, float scale, cudaStream_t stream) {
  using C = Cfg<kBoxes>;
  CUtensorMap tq, tk, tv, tdo;
  int rc = make_map(&tq, q, d, n, bh, kBQ);
  if (rc == 0) rc = make_map(&tdo, dout, d, n, bh, kBQ);
  if (rc == 0) rc = make_map(&tk, k, d, m, bh, kKeys);
  if (rc == 0) rc = make_map(&tv, v, d, m, bh, kKeys);
  if (rc != 0) return rc;
  auto kern = flash_bwd_dkv_sm90<kBoxes, kKS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + kKeys - 1) / kKeys, bh, kBoxes);
  kern<<<grid, kThreads, C::kSmem, stream>>>(tq, tk, tv, tdo, lse, di,
                                             static_cast<__nv_bfloat16*>(dk),
                                             static_cast<__nv_bfloat16*>(dv), n, m, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace bwd

namespace dq {

constexpr int kThreads = 288;   // two consumer warpgroups, then the producer warp
constexpr int kProducer = 256;  // the producer warp's first thread
constexpr int kRows = 128;      // queries per block, 64 per consumer warpgroup
constexpr int kStages = 4;
constexpr int kBK = 64;         // keys per tile

// kBoxes: 64-column boxes of the head dim (1 at D <= 64, 2 up to 128).
template <int kBoxes>
struct Cfg {
  static constexpr int kQBox = kRows * 128;         // one 64-column box of Q or dO
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBox = kBK * 128;          // one box of a K or V tile
  static constexpr int kKVBytes = kBoxes * kKVBox;
  static constexpr int kQOff = 0;
  static constexpr int kDOOff = kQBytes;
  static constexpr int kKOff = 2 * kQBytes;         // stage s: K tile, then V tile
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kBarOff = kKOff + kStages * kStageBytes;
  static constexpr int kQFull = kBarOff;
  static constexpr int kFull = kBarOff + 8;
  static constexpr int kEmpty = kFull + 8 * kStages;
  static constexpr int kSmem = kEmpty + 8 * kStages + 1024;  // + alignment slack
  static_assert(kBoxes == 1 || kBoxes == 2, "head dims up to 128");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// kKS: the 16-column k-steps of S and dP, over the full depth.
template <int kBoxes, int kKS>
__device__ __forceinline__ void consume(uint32_t base, const float* __restrict__ lse,
                                        const float* __restrict__ di,
                                        __nv_bfloat16* __restrict__ dq, int n, int m, int d,
                                        float scale) {
  using C = Cfg<kBoxes>;
  constexpr int kS = kBK / 2;     // S (and dP) registers a thread
  constexpr int kO = 32 * kBoxes; // dQ registers a thread: 64 kBoxes columns
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int ntiles = (m + kBK - 1) / kBK;
  const float scale_log2 = scale * kLog2ef;
  const size_t bh = blockIdx.y;
  const int row0 = blockIdx.x * kRows + wg * 64 + warp * 16 + g;  // and row0 + 8
  const uint32_t q_addr = base + C::kQOff + wg * 64 * 128;  // this warpgroup's 64 queries
  const uint32_t do_addr = base + C::kDOOff + wg * 64 * 128;

  float lse2[2], dir[2];  // P = 0 past N
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < n ? lse[bh * n + row] * kLog2ef : INFINITY;
    dir[r] = row < n ? di[bh * n + row] : 0.f;
  }

  float dq_acc[kO], sc[kS], dp[kS];
  uint32_t pd[kBK / 16][4];  // dS in bf16, the A operand of dQ += dS K
#pragma unroll
  for (int i = 0; i < kO; ++i) dq_acc[i] = 0.f;
  fence_regs(dq_acc);

  mbar_wait(base + C::kQFull, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % kStages;
    const uint32_t k_addr = base + C::kKOff + s * C::kStageBytes;
    const uint32_t v_addr = k_addr + C::kKVBytes;
    mbar_wait(base + C::kFull + 8 * s, (j / kStages) & 1);

    // S = Q K^T, then dP = dO V^T: two groups, waited for one by one. The
    // first k-step overwrites the accumulators (scale-d = 0): zeroing them by
    // hand took 10% longer at (32,4096,4096,40) (PERF.md)
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const uint32_t qoff = (ks >> 2) * C::kQBox + (ks & 3) * 32;  // 16 columns = 32 bytes
      const uint32_t off = (ks >> 2) * C::kKVBox + (ks & 3) * 32;
      WgmmaSS<kBK>::run(sc, desc_sw128(q_addr + qoff, 16, 1024), desc_sw128(k_addr + off, 16, 1024), ks > 0);
    }
    wg_commit();
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const uint32_t qoff = (ks >> 2) * C::kQBox + (ks & 3) * 32;
      const uint32_t off = (ks >> 2) * C::kKVBox + (ks & 3) * 32;
      WgmmaSS<kBK>::run(dp, desc_sw128(do_addr + qoff, 16, 1024), desc_sw128(v_addr + off, 16, 1024), ks > 0);
    }
    wg_commit();

    // P = exp2(S scale log2e - lse2) in place, 0 at keys at or past M. This
    // thread holds queries (rows) g (e = 0, 1) and g + 8 (e = 2, 3) of its
    // warp's 16, keys (columns) 8 c + 2 tq + (e & 1) of the tile.
    wg_wait<1>();
    fence_regs(sc);
#pragma unroll
    for (int i = 0; i < kS; ++i) sc[i] = ex2(fmaf(sc[i], scale_log2, -lse2[(i >> 1) & 1]));
    const int key0 = j * kBK;
    if (key0 + kBK > m) {
#pragma unroll
      for (int i = 0; i < kS; ++i)
        if (key0 + 8 * (i / 4) + 2 * tq + (i & 1) >= m) sc[i] = 0.f;
    }

    // dS = P (dP - di) scale, rounded to bf16 for the product; k-step kk of
    // dQ += dS K covers key columns 16 kk .. 16 kk + 15
    wg_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < kS; ++i) dp[i] = sc[i] * (dp[i] - dir[(i >> 1) & 1]) * scale;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x) pd[kk][x] = pack_bf16x2(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
    }
    fence_frags(pd);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      WgmmaRS<64 * kBoxes>::run(dq_acc, pd[kk], desc_sw128(k_addr + kk * 16 * 128, C::kKVBox, 1024));
    wg_commit();
    wg_wait<0>();
    fence_regs(dq_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(base + C::kEmpty + 8 * s);  // stage s is free
  }

  // epilogue: this warpgroup's real columns of its queries below N, in bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    __nv_bfloat16* dqr = dq + (bh * n + row) * d;
#pragma unroll
    for (int i = 0; i < kO / 4; ++i) {
      const int c = 8 * i + 2 * tq;
      if (c < d)
        *reinterpret_cast<uint32_t*>(dqr + c) = pack_bf16x2(dq_acc[4 * i + 2 * r], dq_acc[4 * i + 2 * r + 1]);
    }
  }
}

template <int kBoxes, int kKS>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  __nv_bfloat16* __restrict__ dq, int n, int m, int d, float scale) {
  using C = Cfg<kBoxes>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms are 1024-aligned

  if (threadIdx.x == 0) {
    mbar_init(base + C::kQFull, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(base + C::kFull + 8 * s, 1);
      mbar_init(base + C::kEmpty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kProducer) {  // the producer warp: its first lane issues every load
    if (threadIdx.x == kProducer) {
      const int q0 = blockIdx.x * kRows, bh = blockIdx.y;
      const int ntiles = (m + kBK - 1) / kBK;
      mbar_expect_tx(base + C::kQFull, 2 * C::kQBytes);
      for (int c = 0; c < kBoxes; ++c) {
        tma_load_3d(base + C::kQOff + c * C::kQBox, &tq, base + C::kQFull, c * 64, q0, bh);
        tma_load_3d(base + C::kDOOff + c * C::kQBox, &tdo, base + C::kQFull, c * 64, q0, bh);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        const uint32_t k_addr = base + C::kKOff + s * C::kStageBytes;
        const uint32_t full = base + C::kFull + 8 * s;
        mbar_wait(base + C::kEmpty + 8 * s, ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * C::kKVBytes);
        for (int c = 0; c < kBoxes; ++c) {
          tma_load_3d(k_addr + c * C::kKVBox, &tk, full, c * 64, j * kBK, bh);
          tma_load_3d(k_addr + C::kKVBytes + c * C::kKVBox, &tv, full, c * 64, j * kBK, bh);
        }
      }
    }
  } else {
    consume<kBoxes, kKS>(base, lse, di, dq, n, m, d, scale);
  }
}

template <int kBoxes, int kKS>
inline int launch_dq(const void* q, const void* k, const void* v, const float* lse,
                     const void* dout, const float* di, void* dq, int bh, int n, int m, int d,
                     float scale, cudaStream_t stream) {
  using C = Cfg<kBoxes>;
  CUtensorMap tq, tk, tv, tdo;
  int rc = make_map(&tq, q, d, n, bh, kRows);
  if (rc == 0) rc = make_map(&tdo, dout, d, n, bh, kRows);
  if (rc == 0) rc = make_map(&tk, k, d, m, bh, kBK);
  if (rc == 0) rc = make_map(&tv, v, d, m, bh, kBK);
  if (rc != 0) return rc;
  auto kern = flash_bwd_dq_sm90<kBoxes, kKS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kRows - 1) / kRows, bh);
  kern<<<grid, kThreads, C::kSmem, stream>>>(tq, tk, tv, tdo, lse, di,
                                             static_cast<__nv_bfloat16*>(dq), n, m, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace dq

// K4 in bf16 at D a multiple of 8 up to 128. The k-steps of S^T and dP^T
// cover D rounded up to 48, 64, 80 or 128 (the port launches D = 40 and 80;
// the zero-filled columns past D add nothing).
inline int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* lse,
                              const void* dout, const void* di, void* dk, void* dv, int bh,
                              int n, int m, int d, float scale, cudaStream_t s) {
  const float* l = static_cast<const float*>(lse);
  const float* r = static_cast<const float*>(di);
  if (d <= 0 || d % 8 != 0 || d > 128) return (int)cudaErrorInvalidValue;
  if (d <= 48) return bwd::launch_dkv<1, 3>(q, k, v, l, dout, r, dk, dv, bh, n, m, d, scale, s);
  if (d <= 64) return bwd::launch_dkv<1, 4>(q, k, v, l, dout, r, dk, dv, bh, n, m, d, scale, s);
  if (d <= 80) return bwd::launch_dkv<2, 5>(q, k, v, l, dout, r, dk, dv, bh, n, m, d, scale, s);
  return bwd::launch_dkv<2, 8>(q, k, v, l, dout, r, dk, dv, bh, n, m, d, scale, s);
}

// K5 in bf16 at D a multiple of 8 up to 128, one instance per k-step count
// of S and dP, as K4 (the port launches D = 40 and 80).
inline int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* lse,
                             const void* dout, const void* di, void* dq, int bh, int n, int m,
                             int d, float scale, cudaStream_t s) {
  const float* l = static_cast<const float*>(lse);
  const float* r = static_cast<const float*>(di);
  if (d <= 0 || d % 8 != 0 || d > 128) return (int)cudaErrorInvalidValue;
  if (d <= 48) return dq::launch_dq<1, 3>(q, k, v, l, dout, r, dq, bh, n, m, d, scale, s);
  if (d <= 64) return dq::launch_dq<1, 4>(q, k, v, l, dout, r, dq, bh, n, m, d, scale, s);
  if (d <= 80) return dq::launch_dq<2, 5>(q, k, v, l, dout, r, dq, bh, n, m, d, scale, s);
  return dq::launch_dq<2, 8>(q, k, v, l, dout, r, dq, bh, n, m, d, scale, s);
}

}  // namespace sm90
}  // namespace reface
