// The Hopper (sm_90a) flash-attention forward loop in bf16: wgmma, a TMA
// ring and 64-row q tiles a consumer warpgroup. One body, `fwd_body`, runs
// every kernel of this design; a variant (`Fwd`) says what the loop
// computes a logit, and the consumer warpgroups a CTA (`NWG`, 1 or 2) its
// q rows (64 a warpgroup):
//   flash_fwd_sm90.cu         K1 (Fwd::K1), K6 (Fwd::K6), K3 (Fwd::K3), NWG 2;
//   attn_diag_sm90.cu         K7, the diagnostic tool's kv loop with one kind
//                             of work taken out (Fwd::FULL .. Fwd::MATMUL_ONLY),
//                             NWG 2;
//   attn_diag_grid3_sm90.cu   K9 (Fwd::K9), NWG 1 or 2;
//   attn_diag_k8_k10_sm90.cu  K8 (Fwd::K8) and K10 (Fwd::K10), NWG 2
// (the last three through attn_diag_sm90.cuh's kernel).
// So the diagnostic kernels time the loop that K1 runs, not a copy of it.
//
// The design, and what bounds it, is set out in flash_fwd_sm90.cu: 64-row
// K/V tiles from TMA into a ring of full and empty mbarriers, both products
// as wgmma with A in registers (P packed straight from S's accumulators),
// S of tile t issued with P V of tile t-1, two P register sets in turn.
// q is scaled by `qscale` and rounded to bf16 as it loads (K1, K6, K8-K10:
// log2(e)/sqrt(d); K3 and K7: 1, which changes no bit). The ring is
// Cfg<DP>::STAGES deep (4 at d <= 64, 3 above), K8's 2 (Var::RING).
//
// What each variant computes a logit, s = q K^T in fp32 (base 2 for K1, K3,
// K6, K8-K10, whose q carries log2(e)/sqrt(d)):
//   K1, K8, K9   running max m (K1 from -inf, K8 and K9 from -1e30, the JAX
//                tool's value), p = exp2(s - m), rescale by exp2(m - m_new)
//                when m grows, l the fp32 sum of p, out = acc / l. K8 is
//                K9's function in a ring of 2 stages: one kv tile in flight
//                while one is computed (below);
//   K10          K9 with l from the ones block, as K6 takes it, under the
//                running max: [O | l] (+)= P [V | 1], l the sum of the
//                ROUNDED p, and the rescale multiplies the ones columns (d <=
//                64) or the ones product (d = 128) by alpha with the rest;
//   K3           K1, and lse2 = m + log2(l) of every row into `lse`;
//   K6           sweep 1: the exact max of every whole row; sweep 2:
//                p = exp2(s - m), no rescale, l the sum of the ROUNDED p
//                from a ones block in shared memory: [O | l] = P [V | 1]
//                (8 more product columns at d <= 64, m64n8k16 of P against
//                the ones above);
//   K7 full      s *= lscale (1/sqrt(d), an FMUL a logit); running max from
//                -inf; p = ex2(s log2(e) - m log2(e)) (an FFMA);
//                alpha = ex2((m - m_new) log2(e)), 0 while m is -inf;
//   K7 exp2      the same with no rescale: the max is committed once per
//                block_k kv rows. Fwd::EXP2 (block_k = 64): each tile's own
//                max(m, tile max). Fwd::EXP2_BLOCKS (block_k = kb 64 rows):
//                K6's two sweeps a block at a time; sweep 1 takes the row
//                max of the raw s over the block's K tiles (times lscale:
//                exact, the scale is positive), then sweep 2 streams the
//                block's K and V tiles with m = max(m, block max); the
//                producer loads each block's K tiles, then its K and V;
//   K7 no_max    s *= lscale, p = ex2(s log2(e)): no max, no rescale;
//   K7 no_exp    s *= lscale, p = s: no SFU;
//   K7 matmul_only  p = bf16(raw s), l = 0: the two products and the loads;
// every K7 variant returns acc / max(l, 1e-20) (matmul_only: acc * 1e20).
//
// Requires D % 8 == 0, D <= 128, 16-byte aligned q/k/v/o and (b, h, n)
// strides that are multiples of 8 elements.
#pragma once

#include <math.h>

#include "sm90.cuh"
#include "sm90_host.cuh"

namespace fwd_sm90 {

using namespace sm90;

constexpr int BN = 64;  // kv rows per tile
constexpr float LOG2E = 1.4426950408889634f;

// the q rows, consumer threads and threads of a CTA with NWG consumer warpgroups
template <int NWG>
struct Team {
  static constexpr int BM = 64 * NWG;                 // q rows per CTA
  static constexpr int NCONSUMER = 128 * NWG;         // consumer threads
  static constexpr int NTHREADS = NCONSUMER + 32;     // and one producer warp
};

// (new variants go last: the enum's values name the kernel instances)
enum class Fwd { K1, K6, K3, K9, FULL, EXP2, EXP2_BLOCKS, NO_MAX, NO_EXP, MATMUL_ONLY, K8, K10 };

template <Fwd V>
struct Var {
  static constexpr bool TWO = V == Fwd::K6;                // K6's two sweeps over the whole row
  static constexpr bool ONES = V == Fwd::K6 || V == Fwd::K10;  // l from the ones block
  static constexpr bool BLOCKS = V == Fwd::EXP2_BLOCKS;    // two sweeps a block of kb tiles
  static constexpr bool LSE = V == Fwd::K3;
  static constexpr bool K7 = V == Fwd::FULL || V == Fwd::EXP2 || V == Fwd::EXP2_BLOCKS || V == Fwd::NO_MAX ||
                             V == Fwd::NO_EXP || V == Fwd::MATMUL_ONLY;
  // a running max over the streamed tiles
  static constexpr bool RUNMAX = V == Fwd::K1 || V == Fwd::K3 || V == Fwd::K9 || V == Fwd::FULL || V == Fwd::EXP2 ||
                                 V == Fwd::K8 || V == Fwd::K10;
  // l and acc rescaled when the max grows
  static constexpr bool RESCALE = V == Fwd::K1 || V == Fwd::K3 || V == Fwd::K9 || V == Fwd::FULL || V == Fwd::K8 ||
                                  V == Fwd::K10;
  // s multiplied by lscale after the product
  static constexpr bool LSCALE = V == Fwd::FULL || V == Fwd::EXP2 || V == Fwd::EXP2_BLOCKS || V == Fwd::NO_MAX ||
                                 V == Fwd::NO_EXP;
  // l accumulates this thread's fp32 sums of P in the streaming sweep
  static constexpr bool SUM = !ONES && V != Fwd::MATMUL_ONLY;
  // the running max's start: -1e30 in the JAX tool's kernels (K8-K10)
  static constexpr float M0 = V == Fwd::K8 || V == Fwd::K9 || V == Fwd::K10 ? -1e30f : -INFINITY;
  // stages of the kv ring, 0 for Cfg<DP>'s. K8 is the TPU kernel that holds
  // a head's whole K and V in VMEM and loads no kv tile ahead; here its K
  // and V cannot stay resident (at [.., 4096, 16] bf16 they take 256 KB,
  // more than an SM's 227 KB of shared memory), so it streams them through
  // the shallowest ring the loop runs: one tile in flight while one is
  // computed. One stage cannot run: `stream` waits for tile t while it
  // still holds tile t-1's stage, which it frees after P V of t-1
  static constexpr int RING = V == Fwd::K8 ? 2 : 0;
};

struct Strides {
  long long qb, qh, qn, kb, kh, kn, vb, vh, vn, ob, oh, on;
};

template <int DP, int S = (DP <= 64 ? 4 : 3)>
struct Cfg {
  static constexpr int CB = DP < 64 ? DP : 64;  // columns of one TMA box (one swizzle row)
  static constexpr int RB = CB * 2;             // its bytes
  static constexpr int TILE = BN * DP * 2;      // bytes of one K or V tile
  static constexpr int STAGES = S;              // stages of the kv ring
  static constexpr uint64_t MODE = RB == 32 ? 3 : RB == 64 ? 2 : 1;  // descriptor swizzle: 32, 64, 128 B
  static constexpr int MINB = DP <= 32 ? 2 : 1;  // CTAs of two warpgroups an SM the registers are sized for
  static constexpr int ONES = BN * RB;  // bytes of bf16 ones: a V tile's first column block
  static constexpr int SMEM = 1024 + STAGES * 2 * TILE + ONES + 2 * STAGES * 8;
};

// the Cfg of variant V: its own ring depth (Var::RING) or Cfg<DP>'s
template <int DP, Fwd V>
using CfgOf = Cfg<DP, Var<V>::RING ? Var<V>::RING : Cfg<DP>::STAGES>;

// kv columns at or past `lim` (M - kv0) get no weight: the ragged last tile
__device__ __forceinline__ void mask_tail(float (&s)[BN / 2], int lim, int tg) {
  if (lim >= BN) return;  // whole tile in range
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (8 * j + 2 * tg + (i & 1) >= lim) s[4 * j + i] = -INFINITY;
}

// m[r] = max(m[r], the max of this thread's values of row r) as a tree
__device__ __forceinline__ void row_max(const float (&s)[BN / 2], float (&m)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t[BN / 8];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) t[j] = fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
#pragma unroll
    for (int w = BN / 16; w > 0; w >>= 1)
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
    m[r] = fmaxf(m[r], t[0]);
  }
}

// row_max over the columns before `lim` (M - kv0) only, without writing
// into s: sweep 1 reads S where wgmma wrote it, and only there
__device__ __forceinline__ void row_max_upto(const float (&s)[BN / 2], float (&m)[2], int lim, int tg) {
  if (lim >= BN) {  // whole tile in range
    row_max(s, m);
    return;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (8 * j + 2 * tg + (i & 1) < lim) m[i >> 1] = fmaxf(m[i >> 1], s[4 * j + i]);
}

// the max over the four threads that share a row
__device__ __forceinline__ void quad_max(float (&m)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
}

// P of one logit against its row's max m (ml = m log2(e), for the base-e variants)
template <Fwd V>
__device__ __forceinline__ float weight(float s, float m, float ml) {
  if constexpr (V == Fwd::FULL || V == Fwd::EXP2 || V == Fwd::EXP2_BLOCKS) return ex2(fmaf(s, LOG2E, -ml));
  else if constexpr (V == Fwd::NO_MAX) return ex2(s * LOG2E);
  else if constexpr (V == Fwd::NO_EXP || V == Fwd::MATMUL_ONLY) return s;
  else return ex2(s - m);
}

// P packed to bf16 A fragments for P V (16 kv rows each: a0 row g kv 2t,
// a1 row g+8, a2 row g kv 2t+8, a3 row g+8); rs = this thread's fp32 sums
// of P by row
template <Fwd V>
__device__ __forceinline__ void exp_pack(const float (&s)[BN / 2], const float (&m)[2], uint32_t (&pa)[BN / 16][4],
                                         float (&rs)[2]) {
  rs[0] = rs[1] = 0.f;
  const float ml[2] = {m[0] * LOG2E, m[1] * LOG2E};
#pragma unroll
  for (int jj = 0; jj < BN / 16; ++jj) {
    float p[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = weight<V>(s[8 * jj + i], m[(i >> 1) & 1], ml[(i >> 1) & 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[jj][i] = pack_bf16(p[2 * i], p[2 * i + 1]);
    rs[0] += (p[0] + p[1]) + (p[4] + p[5]);
    rs[1] += (p[2] + p[3]) + (p[6] + p[7]);
  }
}

// q2 = bf16(q * c) of a bf16 pair, round to nearest even
__device__ __forceinline__ uint32_t prescale(uint32_t raw, float c) {
  return pack_bf16(__uint_as_float(raw << 16) * c, __uint_as_float(raw & 0xffff0000u) * c);
}

// s *= lscale: the base-e logit of the K7 variants that scale it
template <Fwd V>
__device__ __forceinline__ void scale_logits(float (&s)[BN / 2], float lscale) {
  if constexpr (Var<V>::LSCALE) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] *= lscale;
  }
}

// One CTA of the forward: q rows [BM blockIdx.x, + BM) of head blockIdx.y
// (b * H + h), against M kv rows. qscale multiplies q as it loads, lscale
// the logits of the K7 variants that scale them; kb is Fwd::EXP2_BLOCKS's
// tiles a block. lse: K3's fp32 [B, H, N] output.
template <int DP, Fwd V, int NWG>
__device__ __forceinline__ void fwd_body(const CUtensorMap& tmk, const CUtensorMap& tmv, const __nv_bfloat16* __restrict__ q,
                                         __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int N, int M, int D,
                                         const Strides& s, float qscale, float lscale, int kb) {
  using C = CfgOf<DP, V>;
  using T = Team<NWG>;
  using W = Var<V>;
  constexpr bool ONES_COL = W::ONES && DP <= 64;  // K6's and K10's l as 8 more columns of P V
  constexpr bool ONES_MMA = W::ONES && DP > 64;   // K6's and K10's l from a product of its own
  constexpr int NV = ONES_COL ? DP + 8 : DP;  // columns of the P V product
  extern __shared__ uint8_t smem_raw[];
  // [stage][K tile | V tile], the ones block, full barriers, empty barriers
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ones = base + C::STAGES * 2 * C::TILE;
  const uint32_t full0 = ones + C::ONES, empty0 = full0 + 8 * C::STAGES;
  const int ntiles = (M + BN - 1) / BN;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, T::NCONSUMER / 32);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (W::ONES) {  // bf16 ones; the async proxy (wgmma) reads them
    uint32_t* w = reinterpret_cast<uint32_t*>(smem_raw + (ones - smem_u32(smem_raw)));
    for (int i = threadIdx.x; i < C::ONES / 4; i += T::NTHREADS) w[i] = 0x3F803F80u;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == T::NCONSUMER / 32) {  // producer: the two-sweep variants load K alone for sweep 1, then K and V
    if (lane == 0) {
      const int nload = W::TWO || W::BLOCKS ? 2 * ntiles : ntiles;
      for (int it = 0; it < nload; ++it) {
        const int st = it % C::STAGES;
        if (it >= C::STAGES) mbar_wait(empty0 + 8 * st, ((it / C::STAGES) & 1) ^ 1);
        bool with_v;  // load slot `it`: kv tile kv0 / BN, with or without its V tile
        int kv0;
        if constexpr (W::BLOCKS) {  // each block of kb tiles: its K tiles, then its K and V tiles
          const int blk = it / (2 * kb), r = it - 2 * kb * blk;
          with_v = r >= kb;
          kv0 = (blk * kb + (with_v ? r - kb : r)) * BN;
        } else {
          with_v = !W::TWO || it >= ntiles;
          kv0 = (W::TWO && it >= ntiles ? it - ntiles : it) * BN;
        }
        const uint32_t dst = base + st * 2 * C::TILE, bar = full0 + 8 * st;
        mbar_expect_tx(bar, with_v ? 2 * C::TILE : C::TILE);
#pragma unroll
        for (int cb = 0; cb < DP / C::CB; ++cb) {
          tma_load_4d(dst + cb * BN * C::RB, &tmk, cb * C::CB, h, kv0, b, bar);
          if (with_v) tma_load_4d(dst + C::TILE + cb * BN * C::RB, &tmv, cb * C::CB, h, kv0, b, bar);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows [64 wg, 64 wg + 64) of the tile; this
  // thread rows row0 and row0 + 8
  const int g = lane >> 2, tg = lane & 3;
  const int row0 = blockIdx.x * T::BM + (warp >> 2) * 64 + (warp & 3) * 16 + g;
  uint32_t qa[DP / 16][4];
  {
    const __nv_bfloat16* qp = q + b * s.qb + h * s.qh;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + (i & 1) * 8, col = kk * 16 + 2 * tg + (i >> 1) * 8;
        const uint32_t raw = (row < N && col < D) ? *reinterpret_cast<const uint32_t*>(qp + (long long)row * s.qn + col) : 0u;
        qa[kk][i] = prescale(raw, qscale);
      }
  }

  fence_regs(qa);

  auto wait_full = [&](int it) { mbar_wait(full0 + 8 * (it % C::STAGES), (it / C::STAGES) & 1); };
  auto release = [&](int it) {
    if (lane == 0) mbar_arrive(empty0 + 8 * (it % C::STAGES));
  };
  // descriptors of the K tile in load slot `it`, one per 16 of d (K-major)
  auto k_descs = [&](int it, uint64_t (&dk)[DP / 16]) {
    const uint32_t kt = base + (it % C::STAGES) * 2 * C::TILE;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      dk[kk] = desc(kt + (kk * 16 / C::CB) * BN * C::RB + (kk * 16 % C::CB) * 2, 16, 8 * C::RB, C::MODE);
    fence_regs(dk);
  };
  // descriptors of the V tile in load slot `it`, one per 16 kv rows
  // (MN-major). The leading byte offset steps from one column block to the
  // next: the V tile's second at d > 64; for K6 and K10 at d <= 64 the ones block,
  // whose first 8 columns become columns DP .. DP+7 of the product
  auto v_descs = [&](int it, uint64_t (&dv)[BN / 16]) {
    const uint32_t vt = base + (it % C::STAGES) * 2 * C::TILE + C::TILE;
    const uint32_t lbo = ONES_COL ? ones - vt : BN * C::RB;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) dv[j] = desc(vt + j * 16 * C::RB, lbo, 8 * C::RB, C::MODE);
    fence_regs(dv);
  };
  // S = q K^T: one m64n64k16 for each 16 of d
  auto issue_s = [&](float (&sc)[BN / 2], const uint64_t (&dk)[DP / 16]) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) Wgmma<BN, 0>::run(sc, qa[kk], dk[kk], kk > 0);
  };
  float m[2] = {W::M0, W::M0}, l[2] = {0.f, 0.f};

  // sweep 1 over nt K tiles from load slot it1 (kv tile t1): mx = the max of
  // every row's raw s over them. K6: S of tile t+1 runs while tile t is
  // reduced (two S register sets). K7 exp2 a block: one S set, each tile's S
  // waited for before its max is taken; the accumulators of the earlier
  // blocks are live through it, and with K6's second set the instances
  // spill (ptxas: 736-1176 bytes at d <= 32) and run 3x slower
  auto sweep1 = [&](int it1, int t1, int nt, float (&mx)[2]) {
    if constexpr (W::BLOCKS) {
      float sa[BN / 2];
      for (int t = 0; t < nt; ++t) {
        uint64_t dk[DP / 16];
        wait_full(it1 + t);
        k_descs(it1 + t, dk);
        wg_fence();
        issue_s(sa, dk);
        wg_commit();
        wg_wait<0>();
        fence_regs(sa);
        release(it1 + t);
        row_max_upto(sa, mx, M - (t1 + t) * BN, tg);
      }
      quad_max(mx);
      return;
    }
    auto max_step = [&](float (&cur)[BN / 2], float (&nxt)[BN / 2], int t) {
      if (t + 1 < nt) {
        uint64_t dk[DP / 16];
        wait_full(it1 + t + 1);
        k_descs(it1 + t + 1, dk);
        wg_fence();
        issue_s(nxt, dk);
        wg_commit();
        wg_wait<1>();
      } else {
        wg_wait<0>();
      }
      fence_regs(cur);
      release(it1 + t);
      row_max_upto(cur, mx, M - (t1 + t) * BN, tg);  // sweep-1 max
    };
    float sa[BN / 2], sb[BN / 2];
    uint64_t dk[DP / 16];
    wait_full(it1);
    k_descs(it1, dk);
    wg_fence();
    issue_s(sa, dk);
    wg_commit();
    for (int t = 0; t < nt; t += 2) {
      max_step(sa, sb, t);
      if (t + 1 < nt) max_step(sb, sa, t + 1);
    }
    quad_max(mx);
  };

  // [O | l] (+)= P [V | 1]: one m64nNVk16 for each 16 kv rows; at d > 64
  // K6's and K10's l comes from a second product, m64n8k16 against the ones block.
  // Set by start_pv just before the first streaming sweep, after K6's
  // sweep 1, so that nothing of them is live during it
  float acc[NV / 2], lsum[4];
  uint64_t ones_desc;
  auto start_pv = [&] {
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) lsum[i] = 0.f;
    ones_desc = desc(ones, 128, 256, 0);
    if (ONES_MMA) pin(ones_desc);
  };
  auto issue_pv = [&](const uint32_t (&pa)[BN / 16][4], const uint64_t (&dv)[BN / 16]) {
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      Wgmma<NV, 1>::run(acc, pa[j], dv[j], 1);
      if (ONES_MMA) Wgmma<8, 0>::run(lsum, pa[j], ones_desc, 1);
    }
  };

  // the streaming sweep over nt K and V tiles from load slot it0 (kv tile
  // t0): tile 0, then for each next tile its S and the previous tile's P V
  // in flight together. P lives in two register sets that take turns (the
  // loop is unrolled by two), so no copy redefines the A operand of a P V
  // in flight. `first`: l starts from this sweep's sums
  auto stream = [&](int it0, int t0, int nt, bool first) {
    float rs[2];
    uint64_t dk[DP / 16], dv[BN / 16];
    uint32_t pa[BN / 16][4], pb[BN / 16][4];
    {
      float sc[BN / 2];
      wait_full(it0);
      k_descs(it0, dk);
      wg_fence();
      issue_s(sc, dk);
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      scale_logits<V>(sc, lscale);
      mask_tail(sc, M - t0 * BN, tg);
      if (W::RUNMAX) {
        row_max(sc, m);
        quad_max(m);
      }
      exp_pack<V>(sc, m, pa, rs);
      if (W::SUM) {
        l[0] = first ? rs[0] : l[0] + rs[0];
        l[1] = first ? rs[1] : l[1] + rs[1];
      }
    }
    // tile t: S of tile t and P V of tile t-1 (from pcur), then P of tile t into pnxt
    auto step = [&](uint32_t (&pcur)[BN / 16][4], uint32_t (&pnxt)[BN / 16][4], int t) {
      wait_full(it0 + t);
      k_descs(it0 + t, dk);
      v_descs(it0 + t - 1, dv);
      float sn[BN / 2];
      fence_regs(acc);
      fence_regs(pcur);
      if (ONES_MMA) fence_regs(lsum);
      wg_fence();
      issue_s(sn, dk);
      wg_commit();
      issue_pv(pcur, dv);
      wg_commit();
      wg_wait<1>();  // S of tile t is in; P V of tile t-1 may still run
      fence_regs(sn);
      scale_logits<V>(sn, lscale);
      mask_tail(sn, M - (t0 + t) * BN, tg);
      float mn[2] = {m[0], m[1]};
      if (W::RUNMAX) {
        row_max(sn, mn);
        quad_max(mn);
      }
      exp_pack<V>(sn, mn, pnxt, rs);
      wg_wait<0>();
      fence_regs(acc);
      if (ONES_MMA) fence_regs(lsum);
      release(it0 + t - 1);
      if (W::RESCALE) {
        const bool grew = mn[0] > m[0] || mn[1] > m[1];
        if (__any_sync(0xffffffffu, grew)) {  // rescale when a row's max grows
          float alpha[2];  // rescale factors
#pragma unroll
          for (int r = 0; r < 2; ++r)
            alpha[r] = V != Fwd::FULL ? ex2(m[r] - mn[r]) : isfinite(m[r]) ? ex2((m[r] - mn[r]) * LOG2E) : 0.f;
#pragma unroll
          for (int i = 0; i < NV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];  // K10 at d <= 64: its ones columns too
          if (ONES_MMA) {  // K10 at d = 128: the ones product
#pragma unroll
            for (int i = 0; i < 4; ++i) lsum[i] *= alpha[(i >> 1) & 1];
          }
          l[0] *= alpha[0];
          l[1] *= alpha[1];
          m[0] = mn[0];
          m[1] = mn[1];
        }
      } else if (W::RUNMAX) {  // exp2 a tile: the max moves on, nothing is rescaled
        m[0] = mn[0];
        m[1] = mn[1];
      }
      if (W::SUM) {
        l[0] += rs[0];
        l[1] += rs[1];
      }
    };
    // P V of the last tile
    auto finish = [&](uint32_t (&p)[BN / 16][4]) {
      v_descs(it0 + nt - 1, dv);
      fence_regs(acc);
      fence_regs(p);
      if (ONES_MMA) fence_regs(lsum);
      wg_fence();
      issue_pv(p, dv);
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      if (ONES_MMA) fence_regs(lsum);
      release(it0 + nt - 1);
    };
    int t = 1;
    for (; t + 1 < nt; t += 2) {
      step(pa, pb, t);
      step(pb, pa, t + 1);
    }
    if (t < nt) {
      step(pa, pb, t);
      finish(pb);
    } else {
      finish(pa);
    }
  };

  if constexpr (W::BLOCKS) {  // K7 exp2 at block_k = 64 kb: per block, its max, then its P V with that max
    start_pv();
    for (int blk = 0; blk < ntiles / kb; ++blk) {
      float bm[2] = {-INFINITY, -INFINITY};
      sweep1(2 * kb * blk, kb * blk, kb, bm);
      m[0] = fmaxf(m[0], bm[0] * lscale);
      m[1] = fmaxf(m[1], bm[1] * lscale);
      stream(2 * kb * blk + kb, kb * blk, kb, blk == 0);
    }
  } else if constexpr (W::TWO) {  // K6: sweep 1, the exact max of every whole row, then sweep 2
    sweep1(0, 0, ntiles, m);
    start_pv();
    stream(ntiles, 0, ntiles, true);
  } else {
    start_pv();
    stream(0, 0, ntiles, true);
  }

  float inv[2];
  if (W::ONES) {  // every ones column of the product is the row's sum of the rounded P
    inv[0] = 1.f / (ONES_COL ? acc[DP / 2] : lsum[0]);
    inv[1] = 1.f / (ONES_COL ? acc[DP / 2 + 2] : lsum[2]);
  } else {  // each thread summed its own columns: finish the row sums in the quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / (W::K7 ? fmaxf(l[r], 1e-20f) : l[r]);
    }
    if (W::LSE && tg == 0) {  // lse2 of rows row0 and row0 + 8
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < N) lse[(long long)blockIdx.y * N + row] = m[r] + log2f(l[r]);
      }
    }
  }
  __nv_bfloat16* op = o + b * s.ob + h * s.oh;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r, col = 8 * j + 2 * tg;
      if (row < N && col < D)
        *reinterpret_cast<uint32_t*>(op + (long long)row * s.on + col) =
            pack_bf16(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
    }
}

// the tensor maps of K and V: boxes of (16, 32 or 64 columns) x 64 rows
inline int maps(CUtensorMap* tk, CUtensorMap* tv, const void* k, const void* v, int B, int H, int M, int D, const Strides& s) {
  const int box_d = D <= 16 ? 16 : D <= 32 ? 32 : 64;
  const int err = encode(tk, k, B, H, M, D, s.kb, s.kh, s.kn, box_d, BN);
  return err ? err : encode(tv, v, B, H, M, D, s.vb, s.vh, s.vn, box_d, BN);
}

}  // namespace fwd_sm90
