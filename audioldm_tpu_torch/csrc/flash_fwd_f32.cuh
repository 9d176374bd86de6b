// The fp32 flash-attention forward loop on Hopper (sm_90a): 3xTF32 on
// wgmma, a TMA ring with transform warps, 128 q rows a CTA. One body,
// `flash_fwd_f32<DP, V>`, runs every fp32 forward kernel; a variant (`F32`)
// says what the loop computes a logit:
//   flash_attention.cu  K1 (F32::K1), K3 (F32::K3), K6 (F32::K6);
//   attn_diag_f32.cu    K7's five kinds (F32::FULL .. F32::MATMUL_ONLY), K8,
//                       K9 and K10 (F32::K8, K9, K10).
// So the fp32 diagnostic kernels time the loop that the fp32 K1 runs, as the
// bf16 ones run flash_fwd_sm90.cuh's.
//
// What bounds it on an H100: at [2, 8, 4096, 16] (the UNet's level-0
// self-attention under `--fp32`) 17.2 GFLOP of products: 0.256 ms of fp32
// FMA at 67 TFLOP/s, which no SIMT kernel can beat (the first designs, one
// thread a q row with FFMA, took 0.77 ms for K1, 1.06 for K7 full), 0.104
// ms as three TF32 tensor-core products at 495 TFLOP/s; and 268 M exp2 on
// the SFU, 0.064 ms. The design (3xTF32 on wgmma, as K2 in mrf_conv.cu):
//   - every product is a_hi b_hi + a_lo b_hi + a_hi b_lo in fp32
//     accumulators, the lo*lo term (~2^-20 relative) dropped; sm90.cuh's
//     `split`: hi = x truncated to tf32 (one LOP), lo = x - hi (one FADD),
//     whose tf32 part the tensor core reads;
//   - a CTA takes 128 q rows: two consumer warpgroups of 64 rows, one TMA
//     warp and three transform warps. K and V tiles of BN kv rows (64 at
//     d = 16, 32 above, where the registers run short) arrive by TMA (4-D
//     tensor maps over the head views, fp32) into a ring of stages with
//     full, ready and empty mbarriers;
//   - S = q2 K^T: m64nBNk8 for each 8 of d, B the K tile K-major as it lies
//     (64-byte swizzle at d = 16, 128-byte column blocks of 32 above). The
//     transform warps truncate the landed K tile to its hi plane in place
//     and write its lo plane at the same offsets beside it. q is loaded
//     once, multiplied by qscale and split; its A fragments stay in
//     registers at d <= 32 (2 D registers a thread), and at d = 64 and 128
//     its hi and lo planes lie in shared memory (no-swizzle core matrices)
//     and are taken by descriptor;
//   - tf32 wgmma has no transposed B, so the transform warps also write V
//     transposed, V^T hi and lo planes ([d][kv] in no-swizzle K-major core
//     matrices), from the landed V tile. P V takes P straight from S's
//     accumulators as its A fragments: a thread holds S columns 2t, 2t+1 of
//     each group of 8, the A fragment wants k = t, t+4, so
//     d[4j+0, 2, 1, 3] -> a0..a3, and V^T's k index of group j holds kv row
//     8j + 2k (k < 4) or 8j + 2(k-4) + 1 (k >= 4): the same sum over kv, no
//     shuffle. P is split in registers (one LOP, one FADD an element). At
//     d <= 32 the V^T lo plane lies right after the hi one, so one product
//     of N = 2D takes P hi against both: two products for each 8 kv, not
//     three (at [2, 8, 4096, 16] the products issue back to back at N = 16
//     and their count, not their FLOPs, sets the pace);
//   - the tensor core's adds into an accumulator lose more than fp32
//     rounding does, and O would get 3 BN/8 adds a tile: summed over the 64
//     tiles of 4096 kv rows that misses the fp32 bound at [2, 8, 4096, 16].
//     So each tile's P V is a fresh sum (its lo terms in a sum of their
//     own, or first), added to O in fp32 registers by an FFMA that also
//     rescales O; S takes its lo products first too;
//   - the softmax takes each row's max once a tile, P = exp2(s2 - m) on the
//     SFU, l the running fp32 sum, O and l rescaled by exp2(m - m_new) once
//     a tile. S of tile t+1 is issued before P V of tile t, and the softmax
//     of tile t+1 runs while P V of tile t still does. No atomics: the same
//     inputs give the same bits.
// Shared memory: a stage is K hi, K lo (BN x D each), V as loaded, V^T hi and
// V^T lo (BN x DV each): 4 stages at d <= 64 (with q's planes 224 KB at
// d = 64). At d = 128 each q tile takes two CTAs, one for each half of V's
// and O's columns (DV = 64; both compute S): its accumulators fit the
// registers, and one stage with q's 128 KB of planes. Grid: ceil(N / 128) x
// (B * H) x D / DV; 384 threads, one CTA an SM.
//
// What each variant computes a logit, s = (q qscale) K^T by the products
// above (qscale: log2(e)/sqrt(d) for K1, K6 and K8-K10; 1 for K3, handed q2,
// and for the K7 kinds):
//   K1, K8, K9   running max m (K1 from -inf, K8 and K9 from -1e30, the JAX
//                tool's value), p = exp2(s - m), O and l rescaled by
//                exp2(m - m_new) a tile, l the fp32 sum of p, out = O / l.
//                K8 is K9 in a ring of 2 stages (1 at d = 128, as K9:
//                two of d = 128's stages do not fit);
//   K10          K9 with l from the ones in P V: at d <= 32 an 8-row group
//                of ones before each stage's V^T hi plane, so that both P V
//                products take 8 more columns, [1 | V^T hi | V^T lo] and
//                [1 | V^T hi]; above, m64n8k8 products of P hi and P lo
//                against an 8 x 8 block of ones. A fresh sum a tile, added
//                to l as O's is to O;
//   K3           K1, and lse2 = m + log2(l) of every row into `lse`;
//   K6           sweep 1 streams K's tiles alone (the transform warps split
//                them, no V^T) and takes the max of every whole row, the
//                ragged tail masked first; sweep 2 streams K and V with
//                p = exp2(s - m), no rescale, l the fp32 sum of p (P rounds
//                to itself in fp32: this is the ones column), out = O / l.
//                Both sweeps issue the same products on the same planes, so
//                S has the same bits in both and no p exceeds 1;
//   K7 full      s *= lscale (1/sqrt(d), an FMUL a logit); running max from
//                -inf a tile; p = ex2((s - m) log2(e)); alpha =
//                ex2((m - m_new) log2(e)), 0 while m is -inf; out = O /
//                max(l, 1e-20), as every K7 kind;
//   K7 exp2      s *= lscale; the max committed once per block_k kv rows,
//                never rescaled. A block of one tile (kb = 1) takes each
//                tile's own max(m, tile max); a wider one K6's two sweeps
//                a block: sweep 1 over the block's K tiles for the row max
//                of the raw s (times lscale: exact, the scale is positive),
//                then sweep 2 over its K and V tiles with m = max(m, block
//                max). The producer loads each block's K tiles, then its K
//                and V tiles;
//   K7 no_max    s *= lscale, p = ex2(s log2(e)): no max, no rescale;
//   K7 no_exp    s *= lscale, p = s: signed and unbounded, split as any P;
//   K7 matmul_only  p = raw s, l = 0: the two products and the loads.
// The ragged last kv tile's columns get no weight: -inf before the max (p =
// 0), or 0 where p = s.
//
// Requires D % 8 == 0, D <= 128, 16-byte aligned q/k/v/o and (b, h, n)
// strides that are multiples of 8 elements, a unit stride along d.
#pragma once

#include <math.h>
#include <string.h>

#include <type_traits>

#include "sm90.cuh"
#include "sm90_host.cuh"

namespace fwd_f32 {

using namespace sm90;

constexpr int NWG = 2;                      // consumer warpgroups, 64 q rows each
constexpr int BM = 64 * NWG;                // q rows a CTA
constexpr int NCONSUMER = 128 * NWG;        // consumer threads
constexpr int NTRANSFORM = 96;              // the three transform warps' threads
// and one TMA warp: 12 warps, three on each SM sub-partition's 16,384
// registers, so at most 168 registers a thread
constexpr int NTHREADS = NCONSUMER + 32 + NTRANSFORM;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long qb, qh, qn, kb, kh, kn, vb, vh, vn, ob, oh, on;
};

// (new variants go last: the enum's values name the kernel instances)
enum class F32 { K1, K3, K6, FULL, EXP2, NO_MAX, NO_EXP, MATMUL_ONLY, K8, K9, K10 };

template <F32 V>
struct Var {
  static constexpr bool LSE = V == F32::K3;
  static constexpr bool TWO = V == F32::K6;      // sweep 1 over the whole row for its max, then sweep 2
  static constexpr bool BLOCKS = V == F32::EXP2;  // the max committed once a block of kb tiles
  static constexpr bool K7 = V == F32::FULL || V == F32::EXP2 || V == F32::NO_MAX || V == F32::NO_EXP ||
                             V == F32::MATMUL_ONLY;
  // a running max a tile, O and l rescaled when it grows
  static constexpr bool RUNMAX = V == F32::K1 || V == F32::K3 || V == F32::FULL || V == F32::K8 || V == F32::K9 ||
                                 V == F32::K10;
  // s multiplied by lscale after the product
  static constexpr bool LSCALE = V == F32::FULL || V == F32::EXP2 || V == F32::NO_MAX || V == F32::NO_EXP;
  static constexpr bool ONES = V == F32::K10;  // l from the ones in P V
  static constexpr bool SUM = !ONES && V != F32::MATMUL_ONLY;  // l the fp32 sum of this thread's p
  // the running max's start: -1e30 in the JAX tool's kernels (K8-K10)
  static constexpr float M0 = V == F32::K8 || V == F32::K9 || V == F32::K10 ? -1e30f : -INFINITY;
  // a masked logit: no weight where p = s is 0, elsewhere -inf
  static constexpr float MASKED = V == F32::NO_EXP || V == F32::MATMUL_ONLY ? 0.f : -INFINITY;
  // stages of the kv ring, 0 for Cfg's: K8 the shallowest the loop runs,
  // one tile in flight while one is computed (the TPU kernel holds a head's
  // whole K and V in VMEM: 512 KB here at [.., 4096, 16], more than an SM's
  // shared memory)
  static constexpr int RING = V == F32::K8 ? 2 : 0;
};

template <int DP, int RING = 0, bool ONES = false>
struct Cfg {
  static constexpr int BN = DP == 16 ? 64 : 32;               // kv rows a tile
  static constexpr int DV = DP < 64 ? DP : 64;                // V and O columns a CTA (d = 128: two CTAs, a half each)
  static constexpr int STAGES = DP == 128 ? 1 : RING ? RING : 4;
  static constexpr bool WIDE = DV <= 32;                      // P V's hi products as one of N = 2 DV (registers allow)
  static constexpr bool QSMEM = DP >= 64;                     // q's planes in shared memory, else in registers
  // K's descriptors computed before the products and pinned (d = 16: 4 of
  // them); above, as each product issues (8 to 32 would not fit the registers)
  static constexpr bool PIN = DP == 16;
  static constexpr int NKD = PIN ? DP / 8 : 1;
  static constexpr int CB = DP < 32 ? DP : 32;                // columns of a K box: one swizzle row
  static constexpr int RB = CB * 4;                           // its bytes
  static constexpr uint64_t MODE = RB == 64 ? 2 : 1;          // descriptor swizzle: 64 or 128 bytes
  static constexpr int KTILE = BN * DP * 4, VTILE = BN * DV * 4;  // bytes of a K plane, of a V plane
  // K10 at DV <= 32: a group of 8 V^T rows of ones right before the V^T hi plane
  static constexpr int ONESG = ONES && WIDE ? BN * 32 : 0;
  // a stage: K hi (TMA, truncated in place), K lo, V as loaded, [ones,] V^T hi, V^T lo
  static constexpr int KHI = 0, KLO = KTILE, VRAW = 2 * KTILE, VTHI = VRAW + VTILE + ONESG, VTLO = VTHI + VTILE;
  static constexpr int STAGE = VTLO + VTILE;
  static constexpr int QPLANE = 64 * DP * 4;                  // a warpgroup's q hi or lo plane
  static constexpr int QBYTES = QSMEM ? NWG * 2 * QPLANE : 0;
  static constexpr int ONESB = ONES && !WIDE ? 256 : 0;       // K10 above: an 8 x 8 block of ones
  static constexpr int SMEM = 1024 + STAGES * STAGE + QBYTES + ONESB + 3 * 8 * STAGES;
  static_assert(SMEM <= 232448, "shared memory of a CTA");
  static_assert(STAGE % 1024 == 0, "each stage's K tile starts on a multiple of 1024 bytes (the swizzle)");
};

template <int DP, F32 V>
using CfgOf = Cfg<DP, Var<V>::RING, Var<V>::ONES>;

// offset in floats of element (row, k) of a no-swizzle K-major operand with
// K extent KEXT: [row/8][k/4] core matrices of 8 rows x 16 bytes
template <int KEXT>
__device__ __forceinline__ int core_off(int row, int k) {
  return ((row >> 3) * (KEXT / 4) + (k >> 2)) * 32 + (row & 7) * 4 + (k & 3);
}

__device__ __forceinline__ float4 split4(float4 x, float4& lo) {
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
  return make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]), __uint_as_float(h[3]));
}

// D[64 x N] (+)= A[64 x 8] B[8 x N] in tf32, as sm90.cuh's WgmmaTF32 (N =
// 16, 32, 64), and at the widths K10's ones add: 8 (the ones product), 24
// and 40 (d = 16: [1 | V^T hi], [1 | V^T hi | V^T lo]), 40 and 72 (d = 32)
template <int N>
struct Tf32 : WgmmaTF32<N> {};

template <>
struct Tf32<8> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Tf32<24> {
  static __device__ __forceinline__ void run(float (&d)[12], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Tf32<40> {
  static __device__ __forceinline__ void run(float (&d)[20], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Tf32<72> {
  static __device__ __forceinline__ void run(float (&d)[36], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

// P of one logit against its row's max m
template <F32 V>
__device__ __forceinline__ float weight(float s, float m) {
  if constexpr (V == F32::FULL || V == F32::EXP2) return ex2((s - m) * LOG2E);
  else if constexpr (V == F32::NO_MAX) return ex2(s * LOG2E);
  else if constexpr (V == F32::NO_EXP || V == F32::MATMUL_ONLY) return s;
  else return ex2(s - m);
}

// One CTA of the forward: q rows [BM blockIdx.x, + BM) of head blockIdx.y
// (b * H + h), V and O columns [DV blockIdx.z, + DV), against M kv rows.
// qscale multiplies q as it loads, lscale the logits of the K7 kinds that
// scale them; kb is K7 exp2's tiles a block. lse: K3's fp32 [B, H, N] output.
template <int DP, F32 V>
__global__ void __launch_bounds__(NTHREADS, 1) flash_fwd_f32(
    const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv, const float* __restrict__ q,
    float* __restrict__ o, float* __restrict__ lse, int H, int N, int M, int D, Strides s, float qscale, float lscale,
    int kb) {
  using C = CfgOf<DP, V>;
  using W = Var<V>;
  constexpr int BN = C::BN, S = C::STAGES;
  constexpr bool ONES_COL = W::ONES && C::WIDE, ONES_MMA = W::ONES && !C::WIDE;
  constexpr int OFF = ONES_COL ? 4 : 0;  // accumulator index of P V's first V column (the ones group's 4 first)
  constexpr int NPV = C::DV + (ONES_COL ? 8 : 0), NPVW = 2 * C::DV + (ONES_COL ? 8 : 0);  // P V products' N
  extern __shared__ uint8_t smem_raw[];
  // [stage][K hi | K lo | V | ones | V^T hi | V^T lo], q's planes, the ones block, full, ready and empty barriers
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* const fbase = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)));
  const uint32_t qbase = base + S * C::STAGE;
  const uint32_t ones = qbase + C::QBYTES;
  const uint32_t full0 = ones + C::ONESB, ready0 = full0 + 8 * S, empty0 = ready0 + 8 * S;
  const int ntiles = (M + BN - 1) / BN;
  const bool blocks = W::BLOCKS && kb > 1;            // exp2 over blocks of kb tiles: two sweeps a block
  const int nload = W::TWO || blocks ? 2 * ntiles : ntiles;  // load slots: each K tile twice where two sweeps run
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int dv0 = blockIdx.z * C::DV;  // this CTA's V and O columns [dv0, dv0 + DV)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(ready0 + 8 * st, NTRANSFORM);
      mbar_init(empty0 + 8 * st, NCONSUMER / 32);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (W::ONES) {  // K10's ones (nothing else writes there); the async proxy (wgmma) reads them
    if constexpr (ONES_COL) {  // each stage's group
      for (int i = threadIdx.x; i < S * C::ONESG / 4; i += NTHREADS)
        fbase[((i / (C::ONESG / 4)) * C::STAGE + C::VTHI - C::ONESG) / 4 + i % (C::ONESG / 4)] = 1.f;
    } else {
      for (int i = threadIdx.x; i < C::ONESB / 4; i += NTHREADS) fbase[(ones - base) / 4 + i] = 1.f;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // load slot `it`: its kv tile, and whether V comes with K (sweep 1 loads K alone)
  auto slot = [&](int it, int& tile) -> bool {
    if constexpr (W::TWO) {  // the whole row's K tiles, then its K and V tiles
      tile = it < ntiles ? it : it - ntiles;
      return it >= ntiles;
    } else if constexpr (W::BLOCKS) {  // each block's K tiles, then its K and V tiles
      if (!blocks) {
        tile = it;
        return true;
      }
      const int blk = it / (2 * kb), r = it - 2 * kb * blk;
      tile = blk * kb + (r < kb ? r : r - kb);
      return r >= kb;
    } else {
      tile = it;
      return true;
    }
  };

  if (warp == NCONSUMER / 32) {  // the TMA warp: the K (and V) tile of slot `it` into stage it % S
    if (lane == 0) {
      for (int it = 0; it < nload; ++it) {
        const int st = it % S;
        if (it >= S) mbar_wait(empty0 + 8 * st, ((it / S) & 1) ^ 1);
        int tile;
        const bool with_v = slot(it, tile);
        const uint32_t dst = base + st * C::STAGE, bar = full0 + 8 * st;
        mbar_expect_tx(bar, with_v ? C::KTILE + C::VTILE : C::KTILE);
#pragma unroll
        for (int cb = 0; cb < DP / C::CB; ++cb)
          tma_load_4d(dst + C::KHI + cb * BN * C::RB, &tmk, cb * C::CB, h, tile * BN, b, bar);
        if (with_v) tma_load_4d(dst + C::VRAW, &tmv, dv0, h, tile * BN, b, bar);
      }
    }
    return;
  }

  if (warp > NCONSUMER / 32) {  // the transform warps: the landed tile's K hi/lo and V^T hi/lo planes
    const int tw = warp - NCONSUMER / 32 - 1, ttid = threadIdx.x - NCONSUMER - 32;
    // V^T: each lane one d and four kv (16 bytes of a core matrix); a warp
    // reads DL consecutive d of KL kv rows (no bank conflict) and writes
    // whole core matrices
    constexpr int DV = C::DV, DL = DV < 32 ? DV : 32, KL = 32 / DL, ND = DV / DL, NK = BN / 4 / KL;
    for (int it = 0; it < nload; ++it) {
      const int st = it % S;
      int tile;
      const bool with_v = slot(it, tile);
      mbar_wait(full0 + 8 * st, (it / S) & 1);
      float* const stg = fbase + st * C::STAGE / 4;
      float4* const khi = reinterpret_cast<float4*>(stg + C::KHI / 4);
      float4* const klo = reinterpret_cast<float4*>(stg + C::KLO / 4);
      for (int i = ttid; i < C::KTILE / 16; i += NTRANSFORM) {
        float4 lo;
        khi[i] = split4(khi[i], lo);  // the swizzled tile: the same offsets in both planes
        klo[i] = lo;
      }
      if (with_v) {
        const float* const vraw = stg + C::VRAW / 4;
        for (int blk = tw; blk < ND * NK; blk += NTRANSFORM / 32) {
          const int d = (blk % ND) * DL + lane % DL, kq = (blk / ND) * KL + lane / DL;
          const int kv = 8 * (kq >> 1) + (kq & 1);  // V^T's k = 4 (kq & 1) + i of group kq / 2 holds kv row kv + 2 i
          float4 lo;
          const float4 hi = split4(make_float4(vraw[kv * DV + d], vraw[(kv + 2) * DV + d], vraw[(kv + 4) * DV + d],
                                               vraw[(kv + 6) * DV + d]), lo);
          const int off = core_off<BN>(d, 4 * kq);
          *reinterpret_cast<float4*>(stg + C::VTHI / 4 + off) = hi;
          *reinterpret_cast<float4*>(stg + C::VTLO / 4 + off) = lo;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // wgmma (the async proxy) reads them
      mbar_arrive(ready0 + 8 * st);
    }
    return;
  }

  // consumers: warpgroup wg owns q rows [64 wg, 64 wg + 64) of the tile; this
  // thread rows row0 and row0 + 8
  const int wg = warp >> 2, g = lane >> 2, tg = lane & 3;
  const int row0 = blockIdx.x * BM + wg * 64 + (warp & 3) * 16 + g;
  const float* const qp = q + b * s.qb + h * s.qh;
  uint32_t qh[C::QSMEM ? 1 : DP / 8][4], ql[C::QSMEM ? 1 : DP / 8][4];
  const uint32_t qplanes = qbase + wg * 2 * C::QPLANE;  // this warpgroup's q hi plane, then its lo plane
  if constexpr (!C::QSMEM) {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + (i & 1) * 8, col = 8 * kk + tg + (i >> 1) * 4;
        split(row < N && col < D ? qp[(long long)row * s.qn + col] * qscale : 0.f, qh[kk][i], ql[kk][i]);
      }
    fence_regs(qh);
    fence_regs(ql);
  } else {
    float* const qhp = fbase + (qplanes - base) / 4;
    for (int idx = threadIdx.x - 128 * wg; idx < 64 * DP; idx += 128) {
      const int r = idx / DP, col = idx % DP, row = blockIdx.x * BM + wg * 64 + r;
      uint32_t hi, lo;
      split(row < N && col < D ? qp[(long long)row * s.qn + col] * qscale : 0.f, hi, lo);
      qhp[core_off<DP>(r, col)] = __uint_as_float(hi);
      qhp[C::QPLANE / 4 + core_off<DP>(r, col)] = __uint_as_float(lo);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup's planes are written
  }

  auto wait_ready = [&](int it) { mbar_wait(ready0 + 8 * (it % S), (it / S) & 1); };
  auto release = [&](int it) {  // this warp is done with slot it's stage
    if (lane == 0) mbar_arrive(empty0 + 8 * (it % S));
  };
  // the descriptor of K's hi (plane KHI) or lo (KLO) plane of slot `it`
  // for d columns [8 kk, 8 kk + 8) (K-major, swizzled)
  auto k_desc = [&](int it, int kk, int plane) -> uint64_t {
    const uint32_t off = (kk * 8 / C::CB) * BN * C::RB + (kk * 8 % C::CB) * 4;
    return desc(base + (it % S) * C::STAGE + plane + off, 16, 8 * C::RB, C::MODE);
  };
  auto k_descs = [&](int it, uint64_t (&dh)[C::NKD], uint64_t (&dl)[C::NKD]) {
    if constexpr (C::PIN) {
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        dh[kk] = k_desc(it, kk, C::KHI);
        dl[kk] = k_desc(it, kk, C::KLO);
      }
      fence_regs(dh);
      fence_regs(dl);
    }
  };
  // S = q2 K^T of slot `it`: three products for each 8 of d, the two lo
  // products of every 8 first and the hi ones last, the first overwriting
  // (small terms first keep the tensor core's large adds few). Every sweep
  // issues these same products, so a K tile gives the same S in each
  auto issue_s = [&](float (&sc)[BN / 2], int it, const uint64_t (&dh)[C::NKD], const uint64_t (&dl)[C::NKD]) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        uint64_t bh, bl;
        if constexpr (C::PIN) {
          bh = dh[kk];
          bl = dl[kk];
        } else {
          bh = k_desc(it, kk, C::KHI);
          bl = k_desc(it, kk, C::KLO);
        }
        if constexpr (C::QSMEM) {
          const uint64_t ah = desc(qplanes + kk * 256, 128, (DP / 4) * 128, 0);
          if (hi) {
            WgmmaTF32SS<BN>::run(sc, ah, bh, 1);
          } else {
            const uint64_t al = desc(qplanes + C::QPLANE + kk * 256, 128, (DP / 4) * 128, 0);
            WgmmaTF32SS<BN>::run(sc, al, bh, kk > 0);
            WgmmaTF32SS<BN>::run(sc, ah, bl, 1);
          }
        } else if (hi) {
          WgmmaTF32<BN>::run(sc, qh[kk], bh, 1);
        } else {
          WgmmaTF32<BN>::run(sc, ql[kk], bh, kk > 0);
          WgmmaTF32<BN>::run(sc, qh[kk], bl, 1);
        }
      }
  };
  // S of slot `it` alone, waited for
  auto s_alone = [&](float (&sc)[BN / 2], int it) {
    uint64_t dh[C::NKD], dl[C::NKD];
    wait_ready(it);
    k_descs(it, dh, dl);
    wg_fence();
    issue_s(sc, it, dh, dl);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
  };

  // sweep 1 over nt K tiles from slot it1 (kv tile t1): mx = max(mx, every
  // row's s over them, the ragged tail's columns left out). K6 with two
  // stages or more: S of tile t+1 runs while tile t is reduced (two S
  // register sets, the loop unrolled by two with no branch around the next
  // tile's issue: with one, ptxas serializes the wgmma pipeline, C7514,
  // and K6 took 0.113 device ms at [2, 8, 2048, 16] on an H100 instead of
  // 0.081). K7 exp2 a block: one S set, each tile's S waited for before its
  // max is taken; O, l and m of the earlier blocks are live through it,
  // and with a second set the instance spills (ptxas: 244 bytes at d = 16)
  auto sweep1 = [&](int it1, int t1, int nt, float (&mx)[2]) {
    auto take = [&](const float (&x)[BN / 2], int t) {
      const int lim = M - (t1 + t) * BN;  // kv columns of the tile in range
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (lim >= BN || 8 * j + 2 * tg + (i & 1) < lim) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x[4 * j + i]);
    };
    if constexpr (S > 1 && W::TWO) {
      float sa[BN / 2], sb[BN / 2];
      auto issue_next = [&](float (&nxt)[BN / 2], int t) {  // S of tile t+1 into nxt
        uint64_t dh[C::NKD], dl[C::NKD];
        wait_ready(it1 + t + 1);
        k_descs(it1 + t + 1, dh, dl);
        wg_fence();
        issue_s(nxt, it1 + t + 1, dh, dl);
        wg_commit();
      };
      auto take_cur = [&](float (&cur)[BN / 2], int t) {  // tile t's max, its S waited for
        fence_regs(cur);
        release(it1 + t);
        take(cur, t);
      };
      uint64_t dh[C::NKD], dl[C::NKD];
      wait_ready(it1);
      k_descs(it1, dh, dl);
      wg_fence();
      issue_s(sa, it1, dh, dl);
      wg_commit();
      int t = 0;
      for (; t + 2 < nt; t += 2) {  // wg_wait<1>: S of tile t is in, S of tile t+1 may still run
        issue_next(sb, t);
        wg_wait<1>();
        take_cur(sa, t);
        issue_next(sa, t + 1);
        wg_wait<1>();
        take_cur(sb, t + 1);
      }
      if (t + 1 < nt) {
        issue_next(sb, t);
        wg_wait<1>();
        take_cur(sa, t);
        wg_wait<0>();
        take_cur(sb, t + 1);
      } else {
        wg_wait<0>();
        take_cur(sa, t);
      }
    } else {
      float sa[BN / 2];
      for (int t = 0; t < nt; ++t) {
        s_alone(sa, it1 + t);
        release(it1 + t);
        take(sa, t);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
  };

  // O in fp32 registers; each tile's P V is a fresh tensor-core sum, added
  // to O with an FFMA (round to nearest) that also rescales O
  float acc[C::DV / 2], pv[NPV / 2], pvw[C::WIDE ? NPVW / 2 : 1], lsum[ONES_MMA ? 4 : 1], sc[BN / 2];
#pragma unroll
  for (int i = 0; i < C::DV / 2; ++i) acc[i] = 0.f;
  float m[2] = {W::M0, W::M0}, l[2] = {0.f, 0.f};
  // a max taken a tile: the running max, or K7 exp2's at blocks of one tile
  const bool tilemax = W::RUNMAX || (W::BLOCKS && !blocks);

  // the softmax of kv tile t's S in sc: the logit scale, the ragged tail
  // masked, the rows' max once a tile (where one is taken), P in place, l
  // and m moved on; alpha = exp2(m_old - m) rescales the O of the tiles
  // before (0 at the first tile, m = -inf; 1 where nothing rescales)
  auto softmax = [&](int t, float (&alpha)[2]) {
    if constexpr (W::LSCALE) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] *= lscale;
    }
    const int lim = M - t * BN;  // kv columns of tile t in range (the ragged last tile masks the rest)
    if (lim < BN) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (8 * j + 2 * tg + (i & 1) >= lim) sc[4 * j + i] = W::MASKED;
    }
    float mn[2] = {m[0], m[1]};
    if (tilemax) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) mn[(i >> 1) & 1] = fmaxf(mn[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mn[r] = fmaxf(mn[r], __shfl_xor_sync(0xffffffffu, mn[r], 1));
        mn[r] = fmaxf(mn[r], __shfl_xor_sync(0xffffffffu, mn[r], 2));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      alpha[r] = !W::RUNMAX ? 1.f
                 : V == F32::FULL ? (isfinite(m[r]) ? ex2((m[r] - mn[r]) * LOG2E) : 0.f)
                                  : ex2(m[r] - mn[r]);
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      sc[i] = weight<V>(sc[i], mn[(i >> 1) & 1]);
      if constexpr (W::SUM) rs[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (W::SUM) l[r] = l[r] * alpha[r] + rs[r];
      m[r] = mn[r];
    }
  };
  float alpha[2];  // the rescale of O that tile t's P V comes with

  // tile t of a streaming sweep from slot it0 (kv tile t0), its P in sc:
  // P split into P V's A fragments, S of tile t+1 (with NEXT) issued into sc
  // and P V of tile t after it; the softmax of tile t+1 runs while P V still
  // does, then O = O alpha + P V. With one stage (d = 128) S of tile t+1 can
  // only come after tile t's stage is free, after P V
  auto step = [&](int it0, int t0, int t, auto next) {
    constexpr bool NEXT = decltype(next)::value, FUSED = NEXT && S > 1;
    const int it = it0 + t;
    // accumulator d[4j + i] goes to A fragment a[j][i] with 1 and 2 swapped
    uint32_t ph[BN / 8][4], pl[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) split(sc[4 * j + i], ph[j][i == 1 ? 2 : i == 2 ? 1 : i], pl[j][i == 1 ? 2 : i == 2 ? 1 : i]);
    // V^T's descriptors, one per 8 kv; at DV <= 32 one spans the hi plane
    // and the lo plane after it (N = 2 DV), and K10's ones group before them
    uint64_t dh[C::NKD], dl[C::NKD], dvh[BN / 8], dvl[C::WIDE ? 1 : BN / 8];
    if constexpr (FUSED) {
      wait_ready(it + 1);
      k_descs(it + 1, dh, dl);
    }
    const uint32_t stg = base + (it % S) * C::STAGE;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      dvh[j] = desc(stg + C::VTHI - C::ONESG + j * 256, 128, (BN / 4) * 128, 0);
      if constexpr (!C::WIDE) dvl[j] = desc(stg + C::VTLO + j * 256, 128, (BN / 4) * 128, 0);
    }
    uint64_t dones = desc(ones, 128, 256, 0);  // K10 above d = 32: the ones block
    if constexpr (ONES_MMA) {
      pin(dones);
      fence_regs(lsum);
    }
    fence_regs(dvh);
    fence_regs(dvl);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(pv);
    fence_regs(pvw);
    wg_fence();
    if constexpr (FUSED) {
      issue_s(sc, it + 1, dh, dl);
      wg_commit();
    }
    if constexpr (C::WIDE) {  // p_lo v_hi into pv; [p_hi v_hi | p_hi v_lo] into pvw: two products for each 8 kv
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) Tf32<NPV>::run(pv, pl[j], dvh[j], j > 0);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) Tf32<NPVW>::run(pvw, ph[j], dvh[j], j > 0);
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {  // the lo products, the first overwriting pv (and lsum)
        Tf32<C::DV>::run(pv, pl[j], dvh[j], j > 0);
        Tf32<C::DV>::run(pv, ph[j], dvl[j], 1);
        if constexpr (ONES_MMA) Tf32<8>::run(lsum, pl[j], dones, j > 0);
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        Tf32<C::DV>::run(pv, ph[j], dvh[j], 1);
        if constexpr (ONES_MMA) Tf32<8>::run(lsum, ph[j], dones, 1);
      }
    }
    wg_commit();
    float alpha_next[2];
    if constexpr (FUSED) {
      wg_wait<1>();  // S of tile t+1 is in; P V of tile t may still run
      fence_regs(sc);
      softmax(t0 + t + 1, alpha_next);
    }
    wg_wait<0>();
    fence_regs(pv);
    fence_regs(pvw);
    if constexpr (ONES_MMA) fence_regs(lsum);
    release(it);
    if constexpr (C::WIDE) {  // the small sums first
#pragma unroll
      for (int i = 0; i < C::DV / 2; ++i)
        acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pvw[OFF + i] + (pvw[OFF + i + C::DV / 2] + pv[OFF + i]));
    } else {
#pragma unroll
      for (int i = 0; i < C::DV / 2; ++i) acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pv[i]);
    }
    if constexpr (W::ONES) {  // K10: every ones column holds the row's sum of this tile's P
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], ONES_COL ? pvw[2 * r] + pv[2 * r] : lsum[2 * r]);
    }
    if constexpr (NEXT && !FUSED) {
      s_alone(sc, it + 1);
      softmax(t0 + t + 1, alpha_next);
    }
    if constexpr (NEXT) {
      alpha[0] = alpha_next[0];
      alpha[1] = alpha_next[1];
    }
  };
  // a streaming sweep over nt K and V tiles from slot it0 (kv tile t0)
  auto stream = [&](int it0, int t0, int nt) {
    s_alone(sc, it0);
    softmax(t0, alpha);
    for (int t = 0; t + 1 < nt; ++t) step(it0, t0, t, std::true_type{});
    step(it0, t0, nt - 1, std::false_type{});
  };

  if (W::TWO) {  // K6: sweep 1, the max of every whole row, then sweep 2 with it
    sweep1(0, 0, ntiles, m);
    stream(ntiles, 0, ntiles);
  } else if (blocks) {  // K7 exp2 at kb > 1 tiles a block: per block, its max, then its P V with that max
    for (int blk = 0; blk < ntiles / kb; ++blk) {
      float bm[2] = {-INFINITY, -INFINITY};
      sweep1(2 * kb * blk, kb * blk, kb, bm);
      m[0] = fmaxf(m[0], bm[0] * lscale);
      m[1] = fmaxf(m[1], bm[1] * lscale);
      stream(2 * kb * blk + kb, kb * blk, kb);
    }
  } else {
    stream(0, 0, ntiles);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (!W::ONES) {  // each thread summed its own columns: finish the row sums in the quad
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    inv[r] = 1.f / (W::K7 ? fmaxf(l[r], 1e-20f) : l[r]);
  }
  if (W::LSE && tg == 0 && blockIdx.z == 0) {  // lse2 of rows row0 and row0 + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < N) lse[(long long)blockIdx.y * N + row] = m[r] + log2f(l[r]);
    }
  }
  float* const op = o + b * s.ob + h * s.oh;
#pragma unroll
  for (int j = 0; j < C::DV / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r, col = dv0 + 8 * j + 2 * tg;
      if (row < N && col < D)
        *reinterpret_cast<float2*>(op + (long long)row * s.on + col) =
            make_float2(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
    }
}

// One launch of variant V at head dim DP: the tensor maps, then the kernel.
// block_k: K7 exp2's kv rows a committed max, a multiple of the tile's BN
// rows that divides M (read by exp2 alone). Returns a cudaError_t.
template <int DP, F32 V>
int launch_dp(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int N, int M, int D,
              const Strides& s, float qscale, float lscale, int block_k, cudaStream_t st) {
  using C = CfgOf<DP, V>;
  if (Var<V>::BLOCKS && (block_k < C::BN || block_k % C::BN || M % block_k)) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr =
      cudaFuncSetAttribute(flash_fwd_f32<DP, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tk, tv;  // K in swizzled boxes of CB columns; V in one unswizzled box of DV (the transform reads it)
  int err = encode(&tk, k, B, H, M, D, s.kb, s.kh, s.kn, C::CB, C::BN, 4, true);
  if (!err) err = encode(&tv, v, B, H, M, D, s.vb, s.vh, s.vn, C::DV, C::BN, 4, false);
  if (err) return err;
  const dim3 grid((N + BM - 1) / BM, B * H, DP / C::DV);
  flash_fwd_f32<DP, V><<<grid, NTHREADS, C::SMEM, st>>>(tk, tv, static_cast<const float*>(q), static_cast<float*>(o),
                                                        lse, H, N, M, D, s, qscale, lscale, Var<V>::BLOCKS ? block_k / C::BN : 1);
  return (int)cudaGetLastError();
}

// variant V at the head dim that holds D (16, 32, 64 or 128); strides: 12
// element strides (b, h, n) of q, k, v, o
template <F32 V>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int N, int M, int D,
           const long long* strides, float qscale, float lscale, int block_k, void* stream) {
  if (D < 8 || D > 128 || D % 8 || M < 1) return (int)cudaErrorInvalidValue;
  Strides s;
  memcpy(&s, strides, sizeof(s));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D <= 16) return launch_dp<16, V>(q, k, v, o, lse, B, H, N, M, D, s, qscale, lscale, block_k, st);
  if (D <= 32) return launch_dp<32, V>(q, k, v, o, lse, B, H, N, M, D, s, qscale, lscale, block_k, st);
  if (D <= 64) return launch_dp<64, V>(q, k, v, o, lse, B, H, N, M, D, s, qscale, lscale, block_k, st);
  return launch_dp<128, V>(q, k, v, o, lse, B, H, N, M, D, s, qscale, lscale, block_k, st);
}

}  // namespace fwd_f32
