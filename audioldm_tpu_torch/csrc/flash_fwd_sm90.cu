// K1, K6 and K3 in bf16: the flash-attention forward, non-causal, unmasked,
// written for Hopper (sm_90a) with wgmma, a TMA ring and 128-row q tiles;
// K1 and K6 for inference, K3 for training with the logsumexp output that
// the backward kernels (flash_bwd_sm90.cu) recompute the softmax from.
//
// K1 replaces the Pallas TPU kernel `_flash_kernel_nolse`
// (audioldm_tpu/kernels/flash_attention.py:128), K6 `_flash_kernel_one`
// (:133, selected at :197-199 when the kv axis is one block and `_ONE_PASS`
// is on), K3 `_flash_kernel` (:86, launched by `_flash_bh` from
// `_flash_vjp_fwd`). All compute the TPU kernels' function with their arithmetic:
// q2 = bf16(q * log2(e)/sqrt(d)) (the JAX wrapper's `_pad_reshape`, :387;
// here rounded as q loads), s2 = q2 k^T in fp32, softmax in base 2, P
// rounded to bf16 for P V, fp32 accumulation.
//   K1: running max, sum and accumulator (fp32); the accumulator and sum are
//       rescaled only when a row's max grows; l sums the fp32 P.
//   K3: K1 (template flag LSE), and each consumer warpgroup stores
//       lse2 = m + log2(l) of its rows into a contiguous fp32 [B, H, N]
//       buffer (4 bytes a row; the TPU kernel broadcasts it over 128 lanes).
//       It is handed q2 already rounded (scale_log2 = 1: rounding it again
//       changes nothing), which the backward kernels take too.
//   K6: two sweeps over K. Sweep 1 takes the exact max m of every whole
//       row (S = q2 k^T only, no exp2, no P V); sweep 2 computes
//       P = bf16(exp2(s2 - m)) and P V with no rescale, and l is the fp32
//       sum of the ROUNDED P: the P V product is 8 columns wider,
//       [O | l] = P [V | 1], its B operand's second column block a block of
//       bf16 ones in shared memory (the ones column that the TPU wrapper
//       writes into V's padding; here no byte of V moves for it). At d > 64
//       V already spans two column blocks, and l is a product of its own,
//       m64n8k16 of P against the ones (at every d that costs one more wgmma
//       per 16 kv rows: variant `ones_product` of
//       audioldm_tpu_torch/tools/flash_sm90_variants.py).
//
// What bounds them on an H100: at the UNet's level-0 shape [2, 8, 4096, 16]
// one exp2 per logit, 268 M on the SFU (16 a clock an SM): 0.064 ms. The
// products are 17.2 GFLOP (0.017 ms at the bf16 tensor rate), q, k, v, o
// 8.4 MB (0.003 ms at HBM rate). The previous design (flash_attention.cu,
// 64-row q tiles, mma.sync, K fragments read from shared memory with 32-bit
// loads, V with ldmatrix.trans, a 2-stage cp.async ring) took 0.155 ms on
// an H100 80GB HBM3 at 700 W, and with the exp2 removed still 0.11 ms
// (tools/bench_attn_diag.py's matmul_only): products issued as 16x8
// pieces, fragment loads, and L2
// re-reads of K and V by every 64-row q tile. This design:
//   - a CTA takes 128 q rows: two consumer warpgroups of 64 rows and one
//     producer warp, so each K and V tile read from L2 serves 128 rows (the
//     L2 traffic halves: 134 MB a call at the main shape);
//   - both products are wgmma.mma_async: S = q2 K^T (m64n64k16 for each 16
//     of d; A = q2 in registers, B = the K tile, K-major as it lies) and
//     O += P V (m64nDk16 for each 16 kv rows; A = P in registers, packed
//     straight from S's accumulators, whose layout is the A fragment's; B =
//     the V tile read MN-major, imm-trans-b). No K or V fragment is loaded
//     by the threads;
//   - K and V tiles of 64 rows arrive by TMA (cp.async.bulk.tensor, 4-D
//     maps (d, h, n, b) over the head views, swizzled to the row width:
//     32 B at d <= 16, 64 B at d <= 32, 128 B above, two 64-column boxes at
//     d > 64) into a ring of 4 stages (3 at d > 64) with full and empty
//     mbarriers. TMA zero-fills kv rows past M and columns past D; the
//     ragged last tile is still masked to -inf;
//   - within a warpgroup, S of tile t is issued together with P V of tile
//     t-1, and the softmax of tile t runs while P V still does; P lives in
//     two register sets that take turns, so nothing redefines the A
//     operand of a product in flight (ptxas serializes the wgmma pipeline
//     when something does, C7513). The two warpgroups, and the two CTAs an
//     SM at d <= 32, run their softmaxes under each other's products
//     without being made to take turns (forcing turns with named barriers,
//     FlashAttention-3's ping-pong, measured slower at d = 16: variant
//     `pingpong` of the tool above);
//   - K6's sweep 1 keeps two S register sets in turn too: S of tile t+1
//     runs while the max of tile t is taken;
//   - q is pre-scaled and rounded as it loads: no multiply a logit; P is
//     packed with one cvt.rn.bf16x2.f32 a pair; the rescale is skipped
//     when no row of a warp grew its max.
// Grid: ceil(N / 128) x (B * H); 288 threads (nine warps). At d <= 32 the
// registers are sized for two CTAs an SM, which caps a thread at 96 (five
// of the 18 warps share one SM sub-partition's 16384 registers): at
// [2, 8, 4096, 16] 512 CTAs are 1.94 waves of 264, at batch 1 256 CTAs one
// wave (0.97).
//
// Requires D % 8 == 0, D <= 128, 16-byte aligned q/k/v/o and (b, h, n)
// strides that are multiples of 8 elements (the wrapper pads and copies to
// get them).

#include <math.h>
#include <string.h>

#include "sm90.cuh"
#include "sm90_host.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;  // q rows per CTA
constexpr int BN = 64;   // kv rows per tile
constexpr int NCONSUMER = 256;  // two warpgroups
constexpr int NTHREADS = NCONSUMER + 32;  // and one producer warp

struct Strides {
  long long qb, qh, qn, kb, kh, kn, vb, vh, vn, ob, oh, on;
};

template <int DP>
struct Cfg {
  static constexpr int CB = DP < 64 ? DP : 64;  // columns of one TMA box (one swizzle row)
  static constexpr int RB = CB * 2;             // its bytes
  static constexpr int TILE = BN * DP * 2;      // bytes of one K or V tile
  static constexpr int STAGES = DP <= 64 ? 4 : 3;
  static constexpr uint64_t MODE = RB == 32 ? 3 : RB == 64 ? 2 : 1;  // descriptor swizzle: 32, 64, 128 B
  static constexpr int MINB = DP <= 32 ? 2 : 1;  // CTAs an SM the registers are sized for
  static constexpr int ONES = BN * RB;  // bytes of bf16 ones: a V tile's first column block
  static constexpr int SMEM = 1024 + STAGES * 2 * TILE + ONES + 2 * STAGES * 8;
};

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

// P = exp2(s - m) packed to bf16 A fragments for P V (16 kv rows each: a0
// row g kv 2t, a1 row g+8, a2 row g kv 2t+8, a3 row g+8); rs = this
// thread's fp32 sums of P by row
__device__ __forceinline__ void exp_pack(const float (&s)[BN / 2], const float (&m)[2], uint32_t (&pa)[BN / 16][4],
                                         float (&rs)[2]) {
  rs[0] = rs[1] = 0.f;
#pragma unroll
  for (int jj = 0; jj < BN / 16; ++jj) {
    float p[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = ex2(s[8 * jj + i] - m[(i >> 1) & 1]);
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

template <int DP, bool ONE, bool LSE>
__global__ void __launch_bounds__(NTHREADS, Cfg<DP>::MINB) flash_fwd_sm90_kernel(
    const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv,
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int N, int M,
    int D, Strides s, float scale_log2) {
  static_assert(!(ONE && LSE), "K3 is the streaming forward");
  using C = Cfg<DP>;
  constexpr bool ONES_COL = ONE && DP <= 64;  // K6's l as 8 more columns of P V
  constexpr bool ONES_MMA = ONE && DP > 64;   // K6's l from a product of its own
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
      mbar_init(empty0 + 8 * st, NCONSUMER / 32);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (ONE) {  // bf16 ones; the async proxy (wgmma) reads them
    uint32_t* w = reinterpret_cast<uint32_t*>(smem_raw + (ones - smem_u32(smem_raw)));
    for (int i = threadIdx.x; i < C::ONES / 4; i += NTHREADS) w[i] = 0x3F803F80u;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NCONSUMER / 32) {  // producer: K6 loads K alone for sweep 1, then K and V
    if (lane == 0) {
      const int nload = ONE ? 2 * ntiles : ntiles;
      for (int it = 0; it < nload; ++it) {
        const int st = it % C::STAGES;
        if (it >= C::STAGES) mbar_wait(empty0 + 8 * st, ((it / C::STAGES) & 1) ^ 1);
        const bool with_v = !ONE || it >= ntiles;
        const int kv0 = (ONE && it >= ntiles ? it - ntiles : it) * BN;
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
  const int row0 = blockIdx.x * BM + (warp >> 2) * 64 + (warp & 3) * 16 + g;
  uint32_t qa[DP / 16][4];
  {
    const __nv_bfloat16* qp = q + b * s.qb + h * s.qh;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + (i & 1) * 8, col = kk * 16 + 2 * tg + (i >> 1) * 8;
        const uint32_t raw = (row < N && col < D) ? *reinterpret_cast<const uint32_t*>(qp + (long long)row * s.qn + col) : 0u;
        qa[kk][i] = prescale(raw, scale_log2);
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
  // next: the V tile's second at d > 64; for K6 at d <= 64 the ones block,
  // whose first 8 columns become columns DP .. DP+7 of the product
  auto v_descs = [&](int it, uint64_t (&dv)[BN / 16]) {
    const uint32_t vt = base + (it % C::STAGES) * 2 * C::TILE + C::TILE;
    const uint32_t lbo = ONES_COL ? ones - vt : BN * C::RB;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) dv[j] = desc(vt + j * 16 * C::RB, lbo, 8 * C::RB, C::MODE);
    fence_regs(dv);
  };
  // S = q2 K^T: one m64n64k16 for each 16 of d
  auto issue_s = [&](float (&sc)[BN / 2], const uint64_t (&dk)[DP / 16]) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) Wgmma<BN, 0>::run(sc, qa[kk], dk[kk], kk > 0);
  };
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  int it0 = 0;  // load slot of the streaming sweep's first tile
  if (ONE) {  // sweep 1: the exact max of every whole row; S of tile t+1 runs while tile t is reduced
    auto max_step = [&](float (&cur)[BN / 2], float (&nxt)[BN / 2], int t) {
      if (t + 1 < ntiles) {
        uint64_t dk[DP / 16];
        wait_full(t + 1);
        k_descs(t + 1, dk);
        wg_fence();
        issue_s(nxt, dk);
        wg_commit();
        wg_wait<1>();
      } else {
        wg_wait<0>();
      }
      fence_regs(cur);
      release(t);
      row_max_upto(cur, m, M - t * BN, tg);  // sweep-1 max
    };
    float sa[BN / 2], sb[BN / 2];
    uint64_t dk[DP / 16];
    wait_full(0);
    k_descs(0, dk);
    wg_fence();
    issue_s(sa, dk);
    wg_commit();
    for (int t = 0; t < ntiles; t += 2) {
      max_step(sa, sb, t);
      if (t + 1 < ntiles) max_step(sb, sa, t + 1);
    }
    quad_max(m);
    it0 = ntiles;
  }

  // [O | l] (+)= P [V | 1]: one m64nNVk16 for each 16 kv rows; at d > 64
  // K6's l comes from a second product, m64n8k16 against the ones block
  float acc[NV / 2], lsum[4];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) lsum[i] = 0.f;
  uint64_t ones_desc = desc(ones, 128, 256, 0);
  if (ONES_MMA) pin(ones_desc);
  auto issue_pv = [&](const uint32_t (&pa)[BN / 16][4], const uint64_t (&dv)[BN / 16]) {
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      Wgmma<NV, 1>::run(acc, pa[j], dv[j], 1);
      if (ONES_MMA) Wgmma<8, 0>::run(lsum, pa[j], ones_desc, 1);
    }
  };

  // the streaming sweep (K1; sweep 2 of K6): tile 0, then for each next
  // tile its S and the previous tile's P V in flight together. P lives in
  // two register sets that take turns (the loop is unrolled by two), so no
  // copy redefines the A operand of a P V in flight
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
    mask_tail(sc, M, tg);
    if (!ONE) {
      row_max(sc, m);
      quad_max(m);
    }
    exp_pack(sc, m, pa, rs);
    l[0] = rs[0];
    l[1] = rs[1];
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
    mask_tail(sn, M - t * BN, tg);
    float mn[2] = {m[0], m[1]};
    if (!ONE) {
      row_max(sn, mn);
      quad_max(mn);
    }
    exp_pack(sn, mn, pnxt, rs);
    wg_wait<0>();
    fence_regs(acc);
    if (ONES_MMA) fence_regs(lsum);
    release(it0 + t - 1);
    if (!ONE) {
      const bool grew = mn[0] > m[0] || mn[1] > m[1];
      if (__any_sync(0xffffffffu, grew)) {  // rescale when a row's max grows
        const float alpha[2] = {ex2(m[0] - mn[0]), ex2(m[1] - mn[1])};  // rescale factors
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        l[0] *= alpha[0];
        l[1] *= alpha[1];
        m[0] = mn[0];
        m[1] = mn[1];
      }
      l[0] += rs[0];
      l[1] += rs[1];
    }
  };
  // P V of the last tile
  auto finish = [&](uint32_t (&p)[BN / 16][4]) {
    v_descs(it0 + ntiles - 1, dv);
    fence_regs(acc);
    fence_regs(p);
    if (ONES_MMA) fence_regs(lsum);
    wg_fence();
    issue_pv(p, dv);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    if (ONES_MMA) fence_regs(lsum);
    release(it0 + ntiles - 1);
  };
  int t = 1;
  for (; t + 1 < ntiles; t += 2) {
    step(pa, pb, t);
    step(pb, pa, t + 1);
  }
  if (t < ntiles) {
    step(pa, pb, t);
    finish(pb);
  } else {
    finish(pa);
  }

  float inv[2];
  if (ONE) {  // every ones column of the product is the row's sum of the rounded P
    inv[0] = 1.f / (ONES_COL ? acc[DP / 2] : lsum[0]);
    inv[1] = 1.f / (ONES_COL ? acc[DP / 2 + 2] : lsum[2]);
  } else {  // each thread summed its own columns: finish the row sums in the quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];
    }
    if (LSE && tg == 0) {  // lse2 of rows row0 and row0 + 8
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

template <int DP, bool ONE, bool LSE>
int launch(const CUtensorMap& tk, const CUtensorMap& tv, const __nv_bfloat16* q, __nv_bfloat16* o, float* lse, int B,
           int H, int N, int M, int D, const Strides& s, float scale_log2, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(flash_fwd_sm90_kernel<DP, ONE, LSE>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<DP>::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((N + BM - 1) / BM, B * H);
  flash_fwd_sm90_kernel<DP, ONE, LSE><<<grid, NTHREADS, Cfg<DP>::SMEM, st>>>(tk, tv, q, o, lse, H, N, M, D, s,
                                                                             scale_log2);
  return (int)cudaGetLastError();
}

template <bool ONE, bool LSE>
int dispatch(const CUtensorMap& tk, const CUtensorMap& tv, const __nv_bfloat16* q, __nv_bfloat16* o, float* lse,
             int B, int H, int N, int M, int D, const Strides& s, float scale_log2, cudaStream_t st) {
  if (D <= 16) return launch<16, ONE, LSE>(tk, tv, q, o, lse, B, H, N, M, D, s, scale_log2, st);
  if (D <= 32) return launch<32, ONE, LSE>(tk, tv, q, o, lse, B, H, N, M, D, s, scale_log2, st);
  if (D <= 64) return launch<64, ONE, LSE>(tk, tv, q, o, lse, B, H, N, M, D, s, scale_log2, st);
  return launch<128, ONE, LSE>(tk, tv, q, o, lse, B, H, N, M, D, s, scale_log2, st);
}

int maps(CUtensorMap* tk, CUtensorMap* tv, const void* k, const void* v, int B, int H, int M, int D, const Strides& s) {
  const int box_d = D <= 16 ? 16 : D <= 32 ? 32 : 64;
  const int err = encode(tk, k, B, H, M, D, s.kb, s.kh, s.kn, box_d, BN);
  return err ? err : encode(tv, v, B, H, M, D, s.vb, s.vh, s.vn, box_d, BN);
}

// K1 (mode 0), K6 (mode 1) or K3 (mode 2, lse2 into `lse`) on bf16 tensors
int run(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int N, int M, int D,
        const long long* strides, float scale_log2, int mode, void* stream) {
  if (D < 8 || D > 128 || D % 8 || M < 1) return (int)cudaErrorInvalidValue;
  Strides s;
  memcpy(&s, strides, sizeof(s));
  CUtensorMap tk, tv;
  const int err = maps(&tk, &tv, k, v, B, H, M, D, s);
  if (err) return err;
  auto* qq = static_cast<const __nv_bfloat16*>(q);
  auto* oo = static_cast<__nv_bfloat16*>(o);
  auto* ll = static_cast<float*>(lse);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (mode == 1) return dispatch<true, false>(tk, tv, qq, oo, ll, B, H, N, M, D, s, scale_log2, st);
  if (mode == 2) return dispatch<false, true>(tk, tv, qq, oo, ll, B, H, N, M, D, s, scale_log2, st);
  return dispatch<false, false>(tk, tv, qq, oo, ll, B, H, N, M, D, s, scale_log2, st);
}

}  // namespace

// K1 (one = 0) or K6 (one = 1) on bf16 tensors. strides: 12 element strides
// (b, h, n) of q, k, v, o. Returns a cudaError_t: the tensor maps' encoding,
// then cudaGetLastError() after the launch.
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int M, int D,
                              const long long* strides, float scale_log2, int one, void* stream) {
  return run(q, k, v, o, nullptr, B, H, N, M, D, strides, scale_log2, one ? 1 : 0, stream);
}

// K3 on bf16 tensors: as K1, and writes lse2 = m + log2(l) into the
// contiguous fp32 [B, H, N] buffer `lse`. q is the pre-scaled q2 (with
// scale_log2 = 1).
extern "C" int flash_fwd_sm90_lse(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int N,
                                  int M, int D, const long long* strides, float scale_log2, void* stream) {
  return run(q, k, v, o, lse, B, H, N, M, D, strides, scale_log2, 2, stream);
}

// Encodes the two tensor maps of a call `iters` times and launches nothing:
// the host cost of the encoding alone, for the wrapper's timing.
extern "C" int flash_fwd_sm90_encode(const void* k, const void* v, int B, int H, int M, int D, const long long* strides,
                                     int iters) {
  Strides s;
  memcpy(&s, strides, sizeof(s));
  CUtensorMap tk, tv;
  for (int i = 0; i < iters; ++i) {
    const int err = maps(&tk, &tv, k, v, B, H, M, D, s);
    if (err) return err;
  }
  return 0;
}
