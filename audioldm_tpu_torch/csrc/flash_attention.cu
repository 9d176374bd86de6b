// K1 and K3 in fp32: flash-attention forward, non-causal, unmasked; K3
// with the logsumexp output that the backward kernels
// (flash_attention_bwd.cu) recompute the softmax from, K1 without. In bf16
// both are flash_fwd_sm90.cu.
//
// K1 replaces the Pallas TPU kernel `_flash_kernel_nolse`
// (audioldm_tpu/kernels/flash_attention.py:128, launched by
// `_flash_bh(with_lse=False)` from `_flash_fwd_impl`); K3 replaces
// `_flash_kernel` (:86, launched by `_flash_bh` from `_flash_vjp_fwd`). They
// are one kernel body, K3 (template LSE) with one store more per q row:
// lse2 = m + log2(l), the base-2 logsumexp of the scaled logits, into a
// contiguous fp32 [B, H, N] buffer (the TPU kernel broadcasts it over 128
// lanes; here it is 4 bytes a row). K3 is handed q2 = q * log2(e)/sqrt(d)
// with scale_log2 = 1 (fp32 q2 is the same product as the kernel's own).
// What they compute: s2 = (q * scale_log2) k^T in fp32, an online base-2
// softmax (kv columns past M masked before the max), out = (P v) / l with
// l the fp32 sum of P.
//
// O = softmax(Q K^T / sqrt(d)) V over [B, H, N, D] with (b, h, n) strides
// that are multiples of 8 elements, a unit stride along d, 16-byte aligned
// bases and D % 8 == 0, D <= 128 (the wrapper pads and copies to get them),
// so the UNet's q/k/v views of the projection outputs and the merged-heads
// output need no copies.
//
// What bounds it on an H100: at [2, 8, 4096, 16] (the UNet's level-0
// self-attention under `--fp32`) 17.2 GFLOP of products: 0.256 ms of fp32
// FMA at 67 TFLOP/s, which no SIMT kernel can beat (the first design, one
// thread a q row with FFMA, took 0.772 ms, 3.0x that), 0.104 ms as three
// TF32 tensor-core products at 495 TFLOP/s; and 268 M exp2 on the SFU,
// 0.064 ms. The design (3xTF32 on wgmma, as K2 in mrf_conv.cu):
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
//     once, multiplied by scale_log2 and split; its A fragments stay in
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

#include <math.h>
#include <string.h>

#include <type_traits>

#include "sm90.cuh"
#include "sm90_host.cuh"

namespace {

using namespace sm90;

constexpr int NWG = 2;                      // consumer warpgroups, 64 q rows each
constexpr int BM = 64 * NWG;                // q rows a CTA
constexpr int NCONSUMER = 128 * NWG;        // consumer threads
constexpr int NTRANSFORM = 96;              // the three transform warps' threads
// and one TMA warp: 12 warps, three on each SM sub-partition's 16,384
// registers, so at most 168 registers a thread
constexpr int NTHREADS = NCONSUMER + 32 + NTRANSFORM;

struct Strides {
  long long qb, qh, qn, kb, kh, kn, vb, vh, vn, ob, oh, on;
};

template <int DP>
struct Cfg {
  static constexpr int BN = DP == 16 ? 64 : 32;               // kv rows a tile
  static constexpr int DV = DP < 64 ? DP : 64;                // V and O columns a CTA (d = 128: two CTAs, a half each)
  static constexpr int STAGES = DP == 128 ? 1 : 4;
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
  // a stage: K hi (TMA, truncated in place), K lo, V as loaded, V^T hi, V^T lo
  static constexpr int KHI = 0, KLO = KTILE, VRAW = 2 * KTILE, VTHI = VRAW + VTILE, VTLO = VTHI + VTILE;
  static constexpr int STAGE = VTLO + VTILE;
  static constexpr int QPLANE = 64 * DP * 4;                  // a warpgroup's q hi or lo plane
  static constexpr int QBYTES = QSMEM ? NWG * 2 * QPLANE : 0;
  static constexpr int SMEM = 1024 + STAGES * STAGE + QBYTES + 3 * 8 * STAGES;
  static_assert(SMEM <= 232448, "shared memory of a CTA");
};

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

template <int DP, bool LSE>
__global__ void __launch_bounds__(NTHREADS, 1) flash_fwd_f32(
    const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv, const float* __restrict__ q,
    float* __restrict__ o, float* __restrict__ lse, int H, int N, int M, int D, Strides s, float scale_log2) {
  using C = Cfg<DP>;
  constexpr int BN = C::BN, S = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // [stage][K hi | K lo | V | V^T hi | V^T lo], q's planes, full, ready and empty barriers
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* const fbase = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)));
  const uint32_t qbase = base + S * C::STAGE;
  const uint32_t full0 = qbase + C::QBYTES, ready0 = full0 + 8 * S, empty0 = ready0 + 8 * S;
  const int ntiles = (M + BN - 1) / BN;
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
  __syncthreads();

  if (warp == NCONSUMER / 32) {  // the TMA warp: K and V tile `it` into stage it % S
    if (lane == 0) {
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % S;
        if (it >= S) mbar_wait(empty0 + 8 * st, ((it / S) & 1) ^ 1);
        const uint32_t dst = base + st * C::STAGE, bar = full0 + 8 * st;
        mbar_expect_tx(bar, C::KTILE + C::VTILE);
#pragma unroll
        for (int cb = 0; cb < DP / C::CB; ++cb)
          tma_load_4d(dst + C::KHI + cb * BN * C::RB, &tmk, cb * C::CB, h, it * BN, b, bar);
        tma_load_4d(dst + C::VRAW, &tmv, dv0, h, it * BN, b, bar);
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
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % S;
      mbar_wait(full0 + 8 * st, (it / S) & 1);
      float* const stg = fbase + st * C::STAGE / 4;
      float4* const khi = reinterpret_cast<float4*>(stg + C::KHI / 4);
      float4* const klo = reinterpret_cast<float4*>(stg + C::KLO / 4);
      for (int i = ttid; i < C::KTILE / 16; i += NTRANSFORM) {
        float4 lo;
        khi[i] = split4(khi[i], lo);  // the swizzled tile: the same offsets in both planes
        klo[i] = lo;
      }
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
        split(row < N && col < D ? qp[(long long)row * s.qn + col] * scale_log2 : 0.f, qh[kk][i], ql[kk][i]);
      }
    fence_regs(qh);
    fence_regs(ql);
  } else {
    float* const qhp = fbase + (qplanes - base) / 4;
    for (int idx = threadIdx.x - 128 * wg; idx < 64 * DP; idx += 128) {
      const int r = idx / DP, col = idx % DP, row = blockIdx.x * BM + wg * 64 + r;
      uint32_t hi, lo;
      split(row < N && col < D ? qp[(long long)row * s.qn + col] * scale_log2 : 0.f, hi, lo);
      qhp[core_off<DP>(r, col)] = __uint_as_float(hi);
      qhp[C::QPLANE / 4 + core_off<DP>(r, col)] = __uint_as_float(lo);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup's planes are written
  }

  auto wait_ready = [&](int it) { mbar_wait(ready0 + 8 * (it % S), (it / S) & 1); };
  // the descriptor of K's hi (plane KHI) or lo (KLO) plane of tile `it`
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
  // S = q2 K^T of tile `it`: three products for each 8 of d, the two lo
  // products of every 8 first and the hi ones last, the first overwriting
  // (small terms first keep the tensor core's large adds few)
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
  // S of tile `it` alone, waited for
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

  // O in fp32 registers; each tile's P V is a fresh tensor-core sum, added
  // to O with an FFMA (round to nearest) that also rescales O
  float acc[C::DV / 2], pv[C::DV / 2], pvw[C::WIDE ? C::DV : 1], sc[BN / 2];
#pragma unroll
  for (int i = 0; i < C::DV / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // the softmax of tile t's S in sc: the ragged tail masked, the rows' max
  // once a tile, P = exp2(s2 - m) in place, l and m moved on; alpha =
  // exp2(m_old - m) rescales the O of the tiles before (0 at the first
  // tile, m = -inf)
  auto softmax = [&](int t, float (&alpha)[2]) {
    const int lim = M - t * BN;  // kv columns of tile t in range (the ragged last tile masks the rest)
    if (lim < BN) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (8 * j + 2 * tg + (i & 1) >= lim) sc[4 * j + i] = -INFINITY;
    }
    float mn[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) mn[(i >> 1) & 1] = fmaxf(mn[(i >> 1) & 1], sc[i]);
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mn[r] = fmaxf(mn[r], __shfl_xor_sync(0xffffffffu, mn[r], 1));
      mn[r] = fmaxf(mn[r], __shfl_xor_sync(0xffffffffu, mn[r], 2));
      alpha[r] = ex2(m[r] - mn[r]);
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      sc[i] = ex2(sc[i] - mn[(i >> 1) & 1]);
      rs[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + rs[r];
      m[r] = mn[r];
    }
  };
  float alpha[2];  // the rescale of O that tile t's P V comes with
  s_alone(sc, 0);
  softmax(0, alpha);

  // tile t (its P in sc): P split into P V's A fragments, S of tile t+1
  // (with NEXT) issued into sc and P V of tile t after it; the softmax of
  // tile t+1 runs while P V still does, then O = O alpha + P V. With one
  // stage (d = 128) S of tile t+1 can only come after tile t's stage is
  // free, after P V
  auto step = [&](int t, auto next) {
    constexpr bool NEXT = decltype(next)::value, FUSED = NEXT && S > 1;
    // accumulator d[4j + i] goes to A fragment a[j][i] with 1 and 2 swapped
    uint32_t ph[BN / 8][4], pl[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) split(sc[4 * j + i], ph[j][i == 1 ? 2 : i == 2 ? 1 : i], pl[j][i == 1 ? 2 : i == 2 ? 1 : i]);
    // V^T's descriptors, one per 8 kv; at DV <= 32 one spans the hi plane
    // and the lo plane after it (N = 2 DV)
    uint64_t dh[C::NKD], dl[C::NKD], dvh[BN / 8], dvl[C::WIDE ? 1 : BN / 8];
    if constexpr (FUSED) {
      wait_ready(t + 1);
      k_descs(t + 1, dh, dl);
    }
    const uint32_t stg = base + (t % S) * C::STAGE;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      dvh[j] = desc(stg + C::VTHI + j * 256, 128, (BN / 4) * 128, 0);
      if constexpr (!C::WIDE) dvl[j] = desc(stg + C::VTLO + j * 256, 128, (BN / 4) * 128, 0);
    }
    fence_regs(dvh);
    fence_regs(dvl);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(pv);
    fence_regs(pvw);
    wg_fence();
    if constexpr (FUSED) {
      issue_s(sc, t + 1, dh, dl);
      wg_commit();
    }
    if constexpr (C::WIDE) {  // p_lo v_hi into pv; [p_hi v_hi | p_hi v_lo] into pvw: two products for each 8 kv
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) WgmmaTF32<C::DV>::run(pv, pl[j], dvh[j], j > 0);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) WgmmaTF32<2 * C::DV>::run(pvw, ph[j], dvh[j], j > 0);
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {  // the lo products, the first overwriting pv
        WgmmaTF32<C::DV>::run(pv, pl[j], dvh[j], j > 0);
        WgmmaTF32<C::DV>::run(pv, ph[j], dvl[j], 1);
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) WgmmaTF32<C::DV>::run(pv, ph[j], dvh[j], 1);
    }
    wg_commit();
    float alpha_next[2];
    if constexpr (FUSED) {
      wg_wait<1>();  // S of tile t+1 is in; P V of tile t may still run
      fence_regs(sc);
      softmax(t + 1, alpha_next);
    }
    wg_wait<0>();
    fence_regs(pv);
    fence_regs(pvw);
    if (lane == 0) mbar_arrive(empty0 + 8 * (t % S));  // this warp is done with tile t's stage
    if constexpr (C::WIDE) {  // the small sums first
#pragma unroll
      for (int i = 0; i < C::DV / 2; ++i) acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pvw[i] + (pvw[i + C::DV / 2] + pv[i]));
    } else {
#pragma unroll
      for (int i = 0; i < C::DV / 2; ++i) acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pv[i]);
    }
    if constexpr (NEXT && !FUSED) {
      s_alone(sc, t + 1);
      softmax(t + 1, alpha_next);
    }
    if constexpr (NEXT) {
      alpha[0] = alpha_next[0];
      alpha[1] = alpha_next[1];
    }
  };
  for (int t = 0; t + 1 < ntiles; ++t) step(t, std::true_type{});
  step(ntiles - 1, std::false_type{});

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // each thread summed its own columns: finish the row sums in the quad
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  if (LSE && tg == 0 && blockIdx.z == 0) {  // lse2 of rows row0 and row0 + 8
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

template <int DP, bool LSE>
int launch_dp(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int N, int M, int D,
              const Strides& s, float scale_log2, cudaStream_t st) {
  using C = Cfg<DP>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(flash_fwd_f32<DP, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tk, tv;  // K in swizzled boxes of CB columns; V in one unswizzled box of DV (the transform reads it)
  int err = encode(&tk, k, B, H, M, D, s.kb, s.kh, s.kn, C::CB, C::BN, 4, true);
  if (!err) err = encode(&tv, v, B, H, M, D, s.vb, s.vh, s.vn, C::DV, C::BN, 4, false);
  if (err) return err;
  const dim3 grid((N + BM - 1) / BM, B * H, DP / C::DV);
  flash_fwd_f32<DP, LSE><<<grid, NTHREADS, C::SMEM, st>>>(tk, tv, static_cast<const float*>(q), static_cast<float*>(o),
                                                          lse, H, N, M, D, s, scale_log2);
  return (int)cudaGetLastError();
}

template <bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int N, int M, int D,
           const long long* strides, float scale_log2, void* stream) {
  if (D < 8 || D > 128 || D % 8 || M < 1) return (int)cudaErrorInvalidValue;
  Strides s;
  memcpy(&s, strides, sizeof(s));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D <= 16) return launch_dp<16, LSE>(q, k, v, o, lse, B, H, N, M, D, s, scale_log2, st);
  if (D <= 32) return launch_dp<32, LSE>(q, k, v, o, lse, B, H, N, M, D, s, scale_log2, st);
  if (D <= 64) return launch_dp<64, LSE>(q, k, v, o, lse, B, H, N, M, D, s, scale_log2, st);
  return launch_dp<128, LSE>(q, k, v, o, lse, B, H, N, M, D, s, scale_log2, st);
}

}  // namespace

// K1 in fp32 (bf16 K1 is flash_fwd_sm90). strides: 12 element strides
// (b, h, n) of q, k, v, o. Returns a cudaError_t: the tensor maps'
// encoding, then cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int M, int D,
                         const long long* strides, float scale_log2, void* stream) {
  return launch<false>(q, k, v, o, nullptr, B, H, N, M, D, strides, scale_log2, stream);
}

// K3 in fp32 (bf16 K3 is flash_fwd_sm90_lse): as flash_fwd, and writes lse2
// into the contiguous fp32 [B, H, N] buffer `lse`.
extern "C" int flash_fwd_lse(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int N,
                             int M, int D, const long long* strides, float scale_log2, void* stream) {
  return launch<true>(q, k, v, o, static_cast<float*>(lse), B, H, N, M, D, strides, scale_log2, stream);
}
