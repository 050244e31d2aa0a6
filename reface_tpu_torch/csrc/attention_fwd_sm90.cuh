// Hopper attention forward for bf16: K2 (attention_wide.cu's
// reface_wide_attention), K2 with residuals (reface_flash_attention_fwd,
// which also writes one log-sum-exp per query row) and K1 (attention_smalld.cu's
// reface_smalld_attention, with K1's own rules below, at every D it takes).
// fp32 calls do not come here: they run the scalar attn_fwd_kernel of
// attention_common.cuh, which the card's fp32 checks hold tightly to the
// plain version. The dispatch is by dtype in the two .cu files; no bf16 call
// reaches the old kernel.
//
// Replaces: jax/experimental/pallas/ops/tpu/flash_attention.py:758
// (_flash_attention_impl, the library kernel that reface_tpu/ops/attention.py
// :71 calls), with and without save_residuals; and for K1
// reface_tpu/ops/attention_smalld.py:118 and :141 (_kernel, _kernel_tn: one
// function in two TPU operand layouts, which have no Hopper counterpart).
//
// Numerics of K2 and K2r, the library's (flash_attention.py:447-471): fp32
// scores, scaled into log2 units; a running row max m; p = exp2(s - m) in fp32
// goes into the row sum l; p is rounded to bf16 only as the A operand of the
// PV product, which accumulates in fp32; the accumulator is rescaled by
// exp2(m_old - m_new) at each new max; o = acc / l, stored in bf16;
// lse = (m + log2 l) ln 2.
//
// Numerics of K1, the TPU smalld kernel's, by the template option kSmalld,
// which switches two rules:
//   a fixed shift: one shift per row and no running max: the max of the
//     row's scaled scores over keys 0 .. min(256, M) - 1 (_shift,
//     attention_smalld.py:32-36), or none when the caller asks for `fast`;
//     p = exp2(s * scale * log2e - shift) in fp32, never rescaled. p may
//     pass 1 beyond the first 256 keys: fp32 and bf16 have ~2^127 of
//     headroom. The shift comes from a prologue that runs QK^T over the
//     first 256 keys for their max alone, and the main loop computes those
//     scores again: 6% more QK^T at N = 4096, 25% at 1024. Keeping tile 0's
//     64 score registers until tile 1's max is known would need 64 more
//     registers a thread at D = 80 (acc 64 + two score tiles 128), past the
//     168 that ptxas grants. At D <= 128 the ring's stages hold those keys
//     (two 128-key tiles) and the main loop finds them loaded; at
//     128 < D <= 256 they do not fit (kReload): the producer streams K's
//     first 256 keys through the ring once for the prologue alone (V's
//     barrier completes that use empty), and the main loop loads them again
//     from L2: 12.5% more K and V traffic at N = 1024.
//   a rounded sum: the row sum takes p *rounded to bf16*, in fp32, as the TPU
//     kernel's ones-column of V does (attention_smalld.py:55-63): the packed
//     bf16 pairs of the PV operand are widened back (a shift and a mask) and
//     added in registers. A spare ones-column in V's padded width would do
//     the same in the wgmma, but needs a write into every V stage after its
//     TMA lands and has no room at D = 64 or 128.
// K1 writes no lse.
//
// Bound on the card: at D = 512 the tensor cores (4 BH N M D operations, 69
// GFLOP at (2,4096,4096,512): 0.07 ms); at D = 40 the exponential unit (one
// exp2 a score: BH N M = 537 M at (32,4096,4096,40), 0.138 ms at 16 a clock
// on each SM, against 0.087 ms of products); D = 80 is between.
//
// Design. One block = three warpgroups: two consumer warpgroups (warps 0-7)
// and one producer warpgroup (warps 8-11) whose first thread issues every
// load. Each consumer warpgroup runs its products with wgmma m64nNk16:
//   S = Q K^T  both operands in shared memory, K-major (WgmmaSS),
//   O += P V   P from registers (the S accumulator rounded to bf16 in place:
//              its layout is the A fragment's), V in shared memory read
//              MN-major by wgmma's transposed-B mode, so V is never
//              transposed by hand.
// Q, K and V come in by TMA (cp.async.bulk.tensor, 3-D maps {D, N, BH} with
// 64-column boxes and the 128-byte swizzle that wgmma's descriptors read).
// K and V tiles go through a ring of stages (4 at D <= 64, 3 at D <= 128, 2
// above: as many as shared memory holds); each stage has a "full" mbarrier
// for K and one for V (so S can start before V lands) and an "empty"
// mbarrier on which each consumer warp arrives once it is done with the
// stage. Q is loaded once per block. TMA zero-fills what lies beyond the
// tensor: head-dim columns past D (D = 40 reads a 64-column box, D = 80 two),
// query rows past N and keys past M; zero columns change neither S nor the
// stored O, and keys at or past M are masked out of the last tile's max and
// sum.
//
// Registers: setmaxnreg hands the producer's registers (down to 24) to the
// consumers (up to 240), but ptxas still fits the consumers' code into the
// 168 a thread that __launch_bounds__(384, 1) allows. The D <= 384
// instances fit; D = 512 (128 accumulator registers) spills a little and
// ptxas serialises its wgmmas (its "C7512" note, printed by chip_smoke.py).
//
// K1 at 128 < D <= 256 (a 1024 px UNet's d = 160, at 1024 tokens), 64-key
// tiles, 3 stages. D <= 192: the same unsplit shape, 64 query rows a
// warpgroup and the full depth in three 64-column boxes (TMA zero-fills
// 160..191 at d = 160): accumulator 96 registers, scores 32, P 16; 192 KB
// of shared memory. 192 < D <= 256: a 64 x 256 accumulator (128 registers)
// beside a score tile does not fit 168 registers (ptxas spills and
// serialises the wgmmas), so the two warpgroups share one 64-row tile as K2
// does (kSplit), each accumulating half of the output's columns (64
// registers), but each runs QK^T over the full depth instead of exchanging
// partial scores: both hold the same scores bit for bit, so the prologue's
// max needs no exchange either. That runs QK^T twice (1.5x the products),
// at a width no model of the repo uses; 224 KB of shared memory.
//
// D <= 128 (the UNet's 40 and 80): the FlashAttention-3 shape. Each consumer
// warpgroup owns 64 query rows of a 128-row tile and the full depth; key
// tiles of kBN = 128. QK^T takes ceil(D/16) k-steps; the PV product runs at
// the padded width (64 or 128 columns), since an MN-major operand is read in
// whole 64-column swizzle atoms. The two warpgroups take turns to issue
// their products (FlashAttention-3's ping-pong, two named barriers), so that
// one's exp2s run while the other's wgmmas are in flight. At D = 40 the
// exp2s alone take 0.138 ms of a (32,4096,4096,40) call and the products at
// the padded widths 0.12 ms at the peak rate; the kernel takes about 2.7x
// the exp2 time (PERF.md), so their overlap is far from complete.
//
// D in {256, 384, 512} (the VAE's 512): a 64 x 512 fp32 accumulator is 256
// registers a thread for one warpgroup, so the two consumer warpgroups share
// one 64-row query tile and each owns half of the depth: it computes the
// partial scores over its half (QK^T over D/2), the two halves are exchanged
// through shared memory (a double-buffered 2 x 64 x kBN fp32 buffer, one
// named barrier per key tile) and each adds the other's half to its own.
// fp32 addition is commutative, so both warpgroups hold bit-identical
// scores, take the same max, sum and P, and each accumulates its own 256
// output columns (128 registers a thread). Every product is computed once:
// 4 BH N M D operations, no recomputed scores. Shared memory at kBN = 32:
// Q 64 KB + 2 stages x (K 32 + V 32) KB + exchange 32 KB = 224 KB. The grid
// is one block per 64-row tile and head: 128 blocks at serving's (2, 4096)
// for 132 SMs, one wave; 256 at training's batch 4, two. What holds it at
// about a quarter of the tensor-core peak: the m64n32 QK^T reads 3 KB of
// shared memory per 32K multiply-adds (more than the 128 bytes a clock an
// SM's shared memory gives at the tensor-core rate), the two warpgroups
// wait for each other at every tile, and the serialised wgmmas above.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma_sm90.cuh"

namespace reface {
namespace sm90 {

constexpr int kThreads = 384;  // two consumer warpgroups, then the producer warpgroup
constexpr int kProducer = 256; // the producer's first thread, which issues every load
constexpr float kLn2f = 0.6931471805599453f;
constexpr float kLog2ef = 1.4426950408889634f;

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Returns once at most N of this warpgroup's committed wgmma groups are
// pending (they complete in order).
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Keeps the writes of a wgmma's A fragments before the wgmma.fence that
// follows (an asm statement of its own, which the compiler could otherwise
// move them past; ptxas then injects a fence of its own and serialises the
// wgmmas, its notes C7519 and C7520).
template <int N, int M>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operands: rows of
// 128 bytes, 8-row groups `sbo` = 1024 bytes apart (`lbo` unused). MN-major
// operands: 8-row groups along K `sbo` apart, 64-element atoms along MN
// `lbo` apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// ------------------------------------------------------------ configuration

// kDp: the head dim as the boxes hold it (64, 128, 192, 256, 384 or 512);
// kKS: the 16-deep k-steps of QK^T each consumer warpgroup runs; kBN: keys
// per tile; kSplit: the two consumer warpgroups share one 64-row tile, each
// owning half of the output's depth, instead of owning 64 rows each; K2
// splits QK^T's depth too and exchanges the partial scores (kExchange), K1
// (kSmalld) runs it over the full depth in both. The ring is as deep as
// shared memory allows: 4 stages at kDp = 64, 2 when K2 splits, else 3.
template <int kDp, int kKS, int kBN, bool kSplit, bool kSmalld = false>
struct Cfg {
  static constexpr bool kExchange = kSplit && !kSmalld;
  static constexpr int kStages = kExchange ? 2 : (kDp == 64 ? 4 : 3);
  static constexpr int kRowsQ = kSplit ? 64 : 128;
  static constexpr int kBoxes = kDp / 64;            // 64-column (128-byte) boxes
  static constexpr int kQBox = kRowsQ * 128;         // bytes of one Q box
  static constexpr int kKVBox = kBN * 128;           // bytes of one K or V box
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;   // one K (or V) tile
  static constexpr int kNO = kSplit ? kDp / 2 : kDp; // PV width of one warpgroup
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kXOff = kVOff + kStages * kKVBytes;
  static constexpr int kXBytes = kExchange ? 2 * 2 * 64 * kBN * 4 : 0;
  // mbarriers: Q full, then per stage K full, V full, empty
  static constexpr int kBarOff = kXOff + kXBytes;
  static constexpr int kQFull = kBarOff;
  static constexpr int kKFull = kBarOff + 8;
  static constexpr int kVFull = kKFull + 8 * kStages;
  static constexpr int kEmpty = kVFull + 8 * kStages;
  static constexpr int kSmem = kEmpty + 8 * kStages + 1024;  // + alignment slack
  static_assert(kDp % 64 == 0 && kBN % 16 == 0, "tile shapes");
  static_assert(kExchange ? kKS * 32 == kDp : (kKS * 16 <= kDp && kKS * 16 > kDp - 64), "k-steps");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// ------------------------------------------------------------ the kernel

// One consumer warpgroup's state and steps. The arrays live in registers:
// every member function is inlined and indexes them only with constants.
// Shared memory is addressed by 32-bit shared-window offsets from `base`.
template <int kDp, int kKS, int kBN, bool kSplit, bool kSmalld>
struct Consumer {
  using C = Cfg<kDp, kKS, kBN, kSplit, kSmalld>;
  static constexpr int kS = kBN / 2;     // score registers a thread
  static constexpr int kO = C::kNO / 2;  // accumulator registers a thread
  static_assert(!kSmalld || kShiftKeys % kBN == 0, "K1's prologue runs whole key tiles");
  // K1's prologue tiles do not fit the ring: they are loaded twice
  static constexpr bool kReload = kSmalld && C::kStages * kBN < kShiftKeys;

  uint32_t base, q_addr, k_off, v_off;  // this warpgroup's first depth box in a K, V tile
  int wg, t, tq, m;  // t: the thread's index in its warpgroup
  int t0;            // loads of the ring before key tile 0's (kReload: the prologue's)
  float scale_log2;
  float acc[kO];
  float m_run[2], l_run[2];  // the running max (K1: the fixed shift); this thread's share of the row sum
  float sc[kS];              // the scores of one tile, then its probabilities
  uint32_t pa[kBN / 16][4];  // P in bf16, the A operand of PV

  // S_j = Q K_j^T over this warpgroup's depth: issued and committed, not waited for
  __device__ __forceinline__ void issue_scores(int j) {
    const int s = (t0 + j) % C::kStages;
    const uint32_t k_addr = base + C::kKOff + s * C::kKVBytes + k_off;
#pragma unroll
    for (int i = 0; i < kS; ++i) sc[i] = 0.f;
    mbar_wait(base + C::kKFull + 8 * s, ((t0 + j) / C::kStages) & 1);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const uint32_t col = (ks & 3) * 32;  // 16 columns = 32 bytes into the box
      WgmmaSS<kBN>::run(sc, desc_sw128(q_addr + (ks >> 2) * C::kQBox + col, 16, 1024),
                        desc_sw128(k_addr + (ks >> 2) * C::kKVBox + col, 16, 1024), 1);
    }
    wg_commit();
  }

  // O += P_j V_j: issued and committed, not waited for
  __device__ __forceinline__ void issue_pv(int j) {
    const int s = (t0 + j) % C::kStages;
    const uint32_t v_addr = base + C::kVOff + s * C::kKVBytes + v_off;
    mbar_wait(base + C::kVFull + 8 * s, ((t0 + j) / C::kStages) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      WgmmaRS<C::kNO>::run(acc, pa[kk], desc_sw128(v_addr + kk * 16 * 128, C::kKVBox, 1024));
    wg_commit();
  }

  // keys at or past M drop out of the last, ragged tile. This thread holds
  // rows g (e = 0, 1) and g + 8 (e = 2, 3) of its warp's 16, columns
  // 8i + 2 tq + (e & 1) of the tile.
  __device__ __forceinline__ void mask_tail(int j) {
    const int key0 = j * kBN;
    if (key0 + kBN > m) {
#pragma unroll
      for (int i = 0; i < kS; ++i)
        if (key0 + 8 * (i / 4) + 2 * tq + (i & 1) >= m) sc[i] = -INFINITY;
    }
  }

  // K1: m_run = each row's shift, the max of its scaled scores over
  // the first min(kShiftKeys, M) keys, or 0 when `fast`. QK^T runs over those
  // key tiles for their max alone; their stages stay loaded for the main
  // loop, or under kReload are freed at once and the main loop's loads
  // follow in the ring.
  __device__ __forceinline__ void fixed_shift(int fast) {
    m_run[0] = m_run[1] = 0.f;
    if (fast) return;
    const int tiles = min(kShiftKeys / kBN, (m + kBN - 1) / kBN);
    float mx[2] = {-INFINITY, -INFINITY};
    for (int j = 0; j < tiles; ++j) {
      issue_scores(j);
      wg_wait<0>();
      fence_regs(sc);
      mask_tail(j);
#pragma unroll
      for (int i = 0; i < kS / 4; ++i) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          mx[r] = fmaxf(mx[r], fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]));
      }
      if constexpr (kReload) {
        __syncwarp();
        if ((t & 31) == 0) mbar_arrive(base + C::kEmpty + 8 * (j % C::kStages));
      }
    }
    if constexpr (kReload) t0 = tiles;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // max(s) * c is max(s * c): rounding is monotone, and c > 0
      m_run[r] = mx[r] * scale_log2;
    }
  }

  // Tile j's scores (landed) -> P rounded to bf16 in pa, and the row sum.
  // The library's rule: a new running max, the accumulator rescaled, the
  // fp32 p summed. K1's: the fixed shift, p summed as rounded.
  __device__ __forceinline__ void softmax(int j) {
    if constexpr (C::kExchange) {  // add the other warpgroup's half of the depth
      const uint32_t xb = base + C::kXOff + (j & 1) * 2 * 64 * kBN * 4;
      const uint32_t mine = xb + (wg * 64 * kBN + t) * 4;
      const uint32_t other = xb + ((1 - wg) * 64 * kBN + t) * 4;
#pragma unroll
      for (int i = 0; i < kS; ++i)
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(mine + i * 512), "f"(sc[i]) : "memory");
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        float x;
        asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(other + i * 512) : "memory");
        sc[i] += x;
      }
    }
    mask_tail(j);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float shift = m_run[r], alpha = 1.f;
      if constexpr (!kSmalld) {  // the running max, and the rescale it needs
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < kS / 4; ++i) mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        shift = fmaxf(m_run[r], mx * scale_log2);  // finite: key0 < m
        alpha = ex2(m_run[r] - shift);
        m_run[r] = shift;
#pragma unroll
        for (int i = 0; i < kO / 4; ++i) {
          acc[4 * i + 2 * r] *= alpha;
          acc[4 * i + 2 * r + 1] *= alpha;
        }
      }
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kS / 4; ++i) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = ex2(fmaf(sc[4 * i + e], scale_log2, -shift));  // 0 at -inf
          sc[4 * i + e] = p;
          sum += p;
        }
      }
      l_run[r] = l_run[r] * alpha + (kSmalld ? 0.f : sum);  // alpha = 1 under a fixed shift
    }
    // k-step kk of PV covers score columns 16 kk .. 16 kk + 15
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[kk][x] = pack_bf16x2(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
    }
    if constexpr (kSmalld) {  // pa[kk][x] holds row x & 1; bf16 widens by a shift
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          l_run[x & 1] += __uint_as_float(pa[kk][x] << 16) +
                          __uint_as_float(pa[kk][x] & 0xffff0000u);
      }
    }
  }
};

template <int kDp, int kKS, int kBN, bool kSplit, bool kSmalld>
__device__ __forceinline__ void consume(uint32_t base, __nv_bfloat16* __restrict__ o,
                                        float* __restrict__ lse, int n, int m, int d,
                                        float scale_log2, int fast) {
  using C = Cfg<kDp, kKS, kBN, kSplit, kSmalld>;
  constexpr int kO = C::kNO / 2;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;
  const int ntiles = (m + kBN - 1) / kBN;

  Consumer<kDp, kKS, kBN, kSplit, kSmalld> w;
  w.base = base;
  // where this warpgroup's Q rows and depth, and its K and V depth, begin
  const int box0 = kSplit ? wg * (C::kBoxes / 2) : 0;
  const int qk_box0 = C::kExchange ? box0 : 0;
  w.q_addr = base + qk_box0 * C::kQBox + (kSplit ? 0 : wg * 64 * 128);
  w.k_off = qk_box0 * C::kKVBox;
  w.v_off = box0 * C::kKVBox;
  w.wg = wg;
  w.t = tid & 127;
  w.tq = lane & 3;
  w.m = m;
  w.t0 = 0;
  w.scale_log2 = scale_log2;
#pragma unroll
  for (int i = 0; i < kO; ++i) w.acc[i] = 0.f;
  w.m_run[0] = w.m_run[1] = -INFINITY;
  w.l_run[0] = w.l_run[1] = 0.f;

  // Unsplit: the two warpgroups take turns to issue their products (named
  // barrier 2 + wg is this warpgroup's turn, FlashAttention-3's ping-pong),
  // so that one's softmax runs while the other's wgmmas are in flight. Split
  // K2 runs them in step instead: they meet at the exchange of every tile.
  auto turn_wait = [&] {
    if constexpr (!kSplit) asm volatile("bar.sync %0, 256;\n" ::"r"(2 + wg) : "memory");
  };
  auto turn_pass = [&](bool last) {  // warpgroup 1 owes no pass after its last turn
    if constexpr (!kSplit)
      if (!(last && wg == 1)) asm volatile("bar.arrive %0, 256;\n" ::"r"(3 - wg) : "memory");
  };
  mbar_wait(base + C::kQFull, 0);
  if constexpr (kSmalld) w.fixed_shift(fast);
  if (wg == 1) turn_pass(false);  // warpgroup 0 goes first
  for (int j = 0; j < ntiles; ++j) {
    turn_wait();
    w.issue_scores(j);
    turn_pass(false);
    wg_wait<0>();
    fence_regs(w.sc);
    w.softmax(j);
    turn_wait();
    w.issue_pv(j);
    turn_pass(j + 1 == ntiles);
    wg_wait<0>();
    fence_regs(w.acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(base + C::kEmpty + 8 * ((w.t0 + j) % C::kStages));  // tile j's stage is free
  }

  // epilogue: o = acc / l in bf16; lse once per row
  const int g = lane >> 2, tq = lane & 3;
  const size_t bh = blockIdx.y;
  const int col0 = kSplit ? wg * C::kNO : 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = w.l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = blockIdx.x * C::kRowsQ + (kSplit ? 0 : wg * 64) + warp * 16 + g + 8 * r;
    if (row >= n) continue;
    const float inv = 1.f / l;
    if (lse != nullptr && (!kSplit || wg == 0) && tq == 0)
      lse[bh * n + row] = (w.m_run[r] + log2f(l)) * kLn2f;
    __nv_bfloat16* orow = o + (bh * n + row) * d + col0;
#pragma unroll
    for (int i = 0; i < kO / 4; ++i) {
      const int c = 8 * i + 2 * tq;
      if (col0 + c < d)
        *reinterpret_cast<uint32_t*>(orow + c) =
            pack_bf16x2(w.acc[4 * i + 2 * r] * inv, w.acc[4 * i + 2 * r + 1] * inv);
    }
  }
}

template <int kDp, int kKS, int kBN, bool kSplit, bool kSmalld>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
              float* __restrict__ lse, int n, int m, int d, float scale_log2, int fast) {
  using C = Cfg<kDp, kKS, kBN, kSplit, kSmalld>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms are 1024-aligned

  if (threadIdx.x == 0) {
    mbar_init(base + C::kQFull, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(base + C::kKFull + 8 * s, 1);
      mbar_init(base + C::kVFull + 8 * s, 1);
      mbar_init(base + C::kEmpty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kProducer) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kProducer) {
      const int q0 = blockIdx.x * C::kRowsQ, bh = blockIdx.y;
      const int ntiles = (m + kBN - 1) / kBN;
      // K1 under kReload: the prologue's K tiles first, then every tile's K and V
      const int pro = (Consumer<kDp, kKS, kBN, kSplit, kSmalld>::kReload && !fast)
                          ? min(kShiftKeys / kBN, ntiles) : 0;
      mbar_expect_tx(base + C::kQFull, C::kQBytes);
      for (int c = 0; c < C::kBoxes; ++c)
        tma_load_3d(base + c * C::kQBox, &tq, base + C::kQFull, c * 64, q0, bh);
      for (int t = 0; t < pro + ntiles; ++t) {
        const int s = t % C::kStages, j = t < pro ? t : t - pro;
        mbar_wait(base + C::kEmpty + 8 * s, ((t / C::kStages) & 1) ^ 1);
        mbar_expect_tx(base + C::kKFull + 8 * s, C::kKVBytes);
        for (int c = 0; c < C::kBoxes; ++c)
          tma_load_3d(base + C::kKOff + s * C::kKVBytes + c * C::kKVBox, &tk,
                      base + C::kKFull + 8 * s, c * 64, j * kBN, bh);
        if (t < pro) {  // the prologue reads K alone
          mbar_arrive(base + C::kVFull + 8 * s);
          continue;
        }
        mbar_expect_tx(base + C::kVFull + 8 * s, C::kKVBytes);
        for (int c = 0; c < C::kBoxes; ++c)
          tma_load_3d(base + C::kVOff + s * C::kKVBytes + c * C::kKVBox, &tv,
                      base + C::kVFull + 8 * s, c * 64, j * kBN, bh);
      }
    }
  } else {  // consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<kDp, kKS, kBN, kSplit, kSmalld>(base, o, lse, n, m, d, scale_log2, fast);
  }
}

// ------------------------------------------------------------ host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime, so
// that the library needs no -lcuda. nullptr if it cannot be found.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A (BH, rows, D) bf16 tensor as a 3-D map {D, rows, BH} read in boxes of
// 64 columns x box_rows rows, 128-byte swizzle, zero fill out of bounds.
inline int make_map(CUtensorMap* map, const void* ptr, int d, int rows, int bh, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int kDp, int kKS, int kBN, bool kSplit, bool kSmalld = false>
inline int launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int n,
                  int m, int d, float scale_log2, cudaStream_t stream, int fast = 0) {
  using C = Cfg<kDp, kKS, kBN, kSplit, kSmalld>;
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, d, n, bh, C::kRowsQ);
  if (rc == 0) rc = make_map(&tk, k, d, m, bh, kBN);
  if (rc == 0) rc = make_map(&tv, v, d, m, bh, kBN);
  if (rc != 0) return rc;
  auto kern = attn_fwd_sm90<kDp, kKS, kBN, kSplit, kSmalld>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + C::kRowsQ - 1) / C::kRowsQ, bh);
  kern<<<grid, kThreads, C::kSmem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, n,
                                             m, d, scale_log2, fast);
  return (int)cudaGetLastError();
}

// The bf16 forward at D a multiple of 8 up to 128, one instance per k-step
// count of QK^T; kSmalld: K1's rules (lse must be nullptr). A template, so
// that a source builds only the instances it calls.
template <bool kSmalld>
inline int attention_fwd_bf16_d128(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int bh, int n, int m, int d, float scale_log2,
                                   cudaStream_t s, int fast = 0) {
  switch ((d + 15) / 16) {
    case 1: return launch<64, 1, 128, false, kSmalld>(q, k, v, o, lse, bh, n, m, d, scale_log2, s, fast);
    case 2: return launch<64, 2, 128, false, kSmalld>(q, k, v, o, lse, bh, n, m, d, scale_log2, s, fast);
    case 3: return launch<64, 3, 128, false, kSmalld>(q, k, v, o, lse, bh, n, m, d, scale_log2, s, fast);
    case 4: return launch<64, 4, 128, false, kSmalld>(q, k, v, o, lse, bh, n, m, d, scale_log2, s, fast);
    case 5: return launch<128, 5, 128, false, kSmalld>(q, k, v, o, lse, bh, n, m, d, scale_log2, s, fast);
    case 6: return launch<128, 6, 128, false, kSmalld>(q, k, v, o, lse, bh, n, m, d, scale_log2, s, fast);
    case 7: return launch<128, 7, 128, false, kSmalld>(q, k, v, o, lse, bh, n, m, d, scale_log2, s, fast);
    case 8: return launch<128, 8, 128, false, kSmalld>(q, k, v, o, lse, bh, n, m, d, scale_log2, s, fast);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace reface
