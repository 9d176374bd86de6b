// K4 and K5 in bf16: the flash-attention backward, non-causal, unmasked,
// written for Hopper (sm_90a) with wgmma, a TMA ring and 128-row tiles.
//
// K4 `flash_bwd_dkv` replaces the Pallas TPU kernel `_flash_bwd_dkv_kernel`
// (audioldm_tpu/kernels/flash_attention.py:237, launched at :313), K5
// `flash_bwd_dq` replaces `_flash_bwd_dq_kernel` (:264, launched at :340).
// Both compute the TPU kernels' function with their order of roundings
// (:251-260, :274-281). From q2 = bf16(q * log2(e)/sqrt(d)) (handed in
// rounded, as K3 got it), lse2 (from K3) and delta = rowsum(dO o O) (a
// PyTorch reduction) each recomputes
//   P  = exp2(q2 k^T - lse2)                         fp32
//   dS = P o (dO v^T - delta) * scale                fp32 P, rounded to bf16 after
// and accumulates in fp32  dV += bf16(P)^T dO,  dK += bf16(dS)^T q2 (times
// dk_scale = 1/(scale * log2(e)) at the store)  (K4)  or  dQ += bf16(dS) k
// (K5), stored as bf16. Inputs are [B, H, N, D] head views with any
// (b, h, n) strides and a unit stride along d; lse2 and delta are
// contiguous fp32 [B, H, N]. fp32 K4 and K5 are flash_attention_bwd.cu's
// (3xTF32 on wgmma, with transposed hi/lo planes: tf32 wgmma has no
// MN-major B).
//
// What bounds them on an H100: at the training path's [2, 8, 4096, 16] each
// recomputes P, 268 M exp2 on the SFU (16 a clock an SM): 0.064 ms. The
// products are 34 GFLOP (K4: S^T, dP^T, dV, dK) and 26 GFLOP (K5: S, dP,
// dQ), 0.035 and 0.026 ms at the bf16 tensor rate, the traffic about 10 MB
// (0.003 ms). So exp2 sets the bound, as in K1; beside it each logit costs
// two subtractions, two multiplies and two bf16 packs (P and dS; K1 packs
// once), and the conversions may share the SFU's issue rate. The previous
// design (in flash_attention_bwd.cu until this one: mma.sync m16n8k16 issued as
// 16x8 pieces, 4 warps and 64-row tiles a CTA, B fragments read by the
// threads with 32-bit loads and ldmatrix.trans, a 2-stage cp.async ring)
// took 0.200 (K4) and 0.163 ms (K5) on an H100 80GB HBM3 at 700 W; the same
// design cost K1 0.155 ms against 0.114 after its move to this one. Here:
//   - a CTA owns 128 rows (K4 kv rows, K5 q rows): two consumer warpgroups
//     of 64 rows and one producer warp, so each tile read from L2 serves
//     128 rows (at the main shape 512 CTAs each read 256 KB: 134 MB of L2
//     traffic a call, half the previous design's);
//   - every product is wgmma.mma_async with A in registers (sm90.cuh). K4
//     holds its 64 rows of K and V as A fragments and computes the
//     transposed tiles S^T = K q2^T and dP^T = V dO^T (m64nBQk16 for each
//     16 of d, B = the q2 and dO tiles K-major as they lie), so that P^T
//     and dS^T come out of the accumulators in the A fragment's layout and
//     are packed straight into the A operands of dV += P^T dO and dK +=
//     dS^T q2 (m64nDk16 for each 16 q rows, B = the same tiles read
//     MN-major). lse2 and delta are then per column, read from the stage.
//     K5 holds q2 and dO of its rows as A fragments and lse2 and delta in
//     registers: S = q2 K^T and dP = dO V^T (B = the K and V tiles
//     K-major), then dQ += dS K (B = the K tile MN-major). dK, dV and dQ
//     stay in fp32 registers for the whole loop and are stored once: no
//     atomics, the same bits every run;
//   - the tiles arrive by TMA (4-D maps (d, h, n, b) over the head views,
//     swizzled to the row width, sm90_host.cuh) into a ring of 4 stages
//     with full and empty mbarriers; K4's producer warp also copies the
//     tile's lse2 and delta into the stage with 4-byte cp.async, which
//     arrive on the stage's barrier when they land (a [B*H, N] tensor map
//     would need N % 4 == 0);
//   - a ragged last tile is read as the whole tile that ends at the last
//     row (at N or M below the tile width, as one tile zero-filled past
//     the end), and its columns that the previous tile already covered are
//     masked to P = 0 and dS = 0: every box lies inside the tensor, and a
//     kernel that forgot the mask would count those columns twice;
//   - within a warpgroup, S and dP of tile t are issued together with the
//     accumulating products of tile t-1, and P and dS of tile t are
//     computed while those still run; P and dS live in two register sets
//     that take turns, so nothing redefines the A operand of a product in
//     flight (ptxas serializes the wgmma pipeline when something does,
//     C7513). The two warpgroups take turns to issue their products (named
//     barriers, FlashAttention-3's ping-pong), so that one's elementwise
//     work runs under the other's products: K5 0.153 -> 0.140 ms at the
//     main shape, K4 0.194 -> 0.192 (tools/flash_bwd_sm90_variants.py,
//     H100 80GB HBM3 at 700 W).
// Registers decide the tile widths: K4 holds K, V (DP/4 each), dK and dV
// (DP/2 each) besides S^T and dP^T (BQ/2 each) and the packed P^T and dS^T,
// so its q tile is 64 rows at d <= 32, 32 at d = 64 and 16 at d = 128, with
// one register set for P and dS (no overlap) at d = 128; K5's kv tile is 64
// rows at d <= 64 and 32 (one set) at d = 128. One CTA an SM: ptxas
// compiles 288 threads for at most 168 registers a thread (whole
// warpgroups), which d = 16 fits (K4 164, K5 135) and the other head dims
// fill with a few spilled words (d = 128 a few hundred bytes). At
// [2, 8, 4096, 16] 512 CTAs, 3.9 waves. What the variants measured: the
// products alone take 0.104 (K4) and 0.049 ms (K5) at the main shape, far
// above their tensor bound, and the elementwise work adds about as much
// again instead of hiding under them; without exp2 K4 gains 0.008 ms, K5
// 0.012; without the bf16 packs 0.002 and 0.004; two CTAs an SM, three
// warpgroups, a 2-stage ring or narrower tiles lose. K4's eight m64n16k16
// products a tile cost more than their work: with A read from shared
// memory instead of registers its products alone take 0.065 ms instead of
// 0.104 (variant products_only_ss_acc, same run), the lever for a next
// design (P^T and dS^T through shared memory).
//
// Requires D % 8 == 0, D <= 128, 16-byte aligned tensors and (b, h, n)
// strides that are multiples of 8 elements (the wrapper pads and copies to
// get them).

#include <math.h>
#include <string.h>

#include "sm90.cuh"
#include "sm90_host.cuh"

namespace {

using namespace sm90;

constexpr int NWG = 2;                    // consumer warpgroups, 64 rows each
constexpr int ROWS = 64 * NWG;            // rows a CTA owns (K4 kv, K5 q)
constexpr int NCONSUMER = 128 * NWG;
constexpr int NTHREADS = NCONSUMER + 32;  // and one producer warp
constexpr int STAGES = 4;
// The consumer warpgroups take turns to issue their products (named
// barriers 1 .. NWG, FlashAttention-3's ping-pong), so that one's
// elementwise work runs under the others' products. Warpgroup wg waits
// for its turn to issue,
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
// and then hands the turn to the next warpgroup
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (wg + 1) % NWG) : "memory");
}

// element strides (b, h, n) of q2, k, v, dO and of the outputs (K4: dk, dv;
// K5: dq, unused)
struct Strides {
  long long qb, qh, qn, kb, kh, kn, vb, vh, vn, ob, oh, on, xb, xh, xn, yb, yh, yn;
};

// a ring tile of BT rows x DP columns in column boxes of CB (one swizzle row)
template <int DP, int BT>
struct Tile {
  static constexpr int CB = DP < 64 ? DP : 64;
  static constexpr int RB = CB * 2;  // bytes of a box row
  static constexpr int BYTES = BT * DP * 2;
  static constexpr uint64_t MODE = RB == 32 ? 3 : RB == 64 ? 2 : 1;  // descriptor swizzle: 32, 64, 128 B
  // K-major B operand, columns [16 kk, 16 kk + 16) of all BT rows
  static __device__ __forceinline__ uint64_t kmajor(uint32_t t, int kk) {
    return desc(t + (kk * 16 / CB) * BT * RB + (kk * 16 % CB) * 2, 16, 8 * RB, MODE);
  }
  // MN-major B operand (imm-trans-b), rows [16 j, 16 j + 16) of all DP
  // columns; the leading byte offset steps from one column box to the next
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t t, int j) {
    return desc(t + j * 16 * RB, BT * RB, 8 * RB, MODE);
  }
};

template <int DP>
struct Dkv {
  static constexpr int BQ = DP <= 32 ? 64 : DP == 64 ? 32 : 16;  // q rows a tile
  static constexpr bool OVL = DP <= 64;  // two P/dS register sets in turn
  using T = Tile<DP, BQ>;
  static constexpr int SMEM = 1024 + STAGES * 2 * T::BYTES + STAGES * 2 * BQ * 4 + 2 * STAGES * 8;
};

template <int DP>
struct Dq {
  static constexpr int BN = DP <= 64 ? 64 : 32;  // kv rows a tile
  static constexpr bool OVL = DP <= 64;
  using T = Tile<DP, BN>;
  static constexpr int SMEM = 1024 + STAGES * 2 * T::BYTES + 2 * STAGES * 8;
};

// first row of tile t of width bt over n rows: the ragged last tile ends at
// row n (it starts at 0 when n < bt)
__device__ __forceinline__ int tile_start(int t, int n, int bt) { return min(t * bt, max(n - bt, 0)); }

// A fragments (mma.m16n8k16 layout) of rows row0 and row0 + 8 of a
// [rows, D] bf16 matrix with row stride `stride`: a0 (row0, 2tg), a1
// (row0 + 8, 2tg), a2 (row0, 2tg + 8), a3 (row0 + 8, 2tg + 8) for each 16
// columns; zero past `rows` and D
template <int DP>
__device__ __forceinline__ void load_frags(uint32_t (&a)[DP / 16][4], const __nv_bfloat16* p, long long stride,
                                           int row0, int rows, int D, int tg) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + (i & 1) * 8, col = kk * 16 + 2 * tg + (i >> 1) * 8;
      a[kk][i] = (row < rows && col < D) ? *reinterpret_cast<const uint32_t*>(p + (long long)row * stride + col) : 0u;
    }
}

// P and dS of a thread's accumulator elements of a 64 x W tile (element a:
// row g + 8 ((a >> 1) & 1), column 8 (a >> 2) + 2 tg + (a & 1)), with
// lse2 and delta given per element; columns outside [lo, hi) get P = dS = 0.
// Packed to bf16 A fragments, 16 columns each (the product's k dimension):
// a0 row g col 2tg, a1 row g+8, a2 row g col 2tg+8, a3 row g+8.
template <int W>
__device__ __forceinline__ void grads(const float (&s)[W / 2], const float (&dp)[W / 2], const float (&l2)[W / 2],
                                      const float (&dl)[W / 2], int lo, int hi, int tg, float scale,
                                      uint32_t (&pa)[W / 16][4], uint32_t (&da)[W / 16][4]) {
  const bool whole = lo <= 0 && hi >= W;
#pragma unroll
  for (int jj = 0; jj < W / 16; ++jj) {
    float p[8], ds[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int a = 8 * jj + i, c = 16 * jj + 8 * (i >> 2) + 2 * tg + (i & 1);
      p[i] = ex2(s[a] - l2[a]);
      ds[i] = p[i] * (dp[a] - dl[a]) * scale;
      if (!whole && (c < lo || c >= hi)) p[i] = ds[i] = 0.f;  // masked column
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      pa[jj][k] = pack_bf16(p[2 * k], p[2 * k + 1]);
      da[jj][k] = pack_bf16(ds[2 * k], ds[2 * k + 1]);
    }
  }
}

// K4: the CTA owns kv rows [128 blockIdx.x, +128) of head blockIdx.y and
// loops over q tiles of BQ rows
template <int DP>
__global__ void __launch_bounds__(NTHREADS, 1) flash_bwd_dkv_sm90_kernel(
    const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmo,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, int N,
    int M, int D, Strides s, float scale, float dk_scale) {
  using C = Dkv<DP>;
  using T = typename C::T;
  constexpr int BQ = C::BQ;
  extern __shared__ uint8_t smem_raw[];
  // [stage][q2 tile | dO tile], [stage][lse2 | delta] (BQ floats each), full barriers, empty barriers
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t vec0 = base + STAGES * 2 * T::BYTES;
  const uint32_t full0 = vec0 + STAGES * 2 * BQ * 4, empty0 = full0 + 8 * STAGES;
  float* vec = reinterpret_cast<float*>(smem_raw + (vec0 - raw));
  const int ntiles = (N + BQ - 1) / BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1 + 32);  // the expect_tx of lane 0, then every producer lane's copies
      mbar_init(empty0 + 8 * st, NCONSUMER / 32);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NCONSUMER / 32) {  // producer: q2 and dO tiles by TMA, lse2 and delta by the lanes' cp.async
    const float* lp = lse + (long long)bh * N;
    const float* dp = delta + (long long)bh * N;
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % STAGES;
      if (it >= STAGES) mbar_wait(empty0 + 8 * st, ((it / STAGES) & 1) ^ 1);
      const int q0 = tile_start(it, N, BQ);
      const uint32_t dst = base + st * 2 * T::BYTES, bar = full0 + 8 * st;
      if (lane == 0) {
        mbar_expect_tx(bar, 2 * T::BYTES);
#pragma unroll
        for (int cb = 0; cb < DP / T::CB; ++cb) {
          tma_load_4d(dst + cb * BQ * T::RB, &tmq, cb * T::CB, h, q0, b, bar);
          tma_load_4d(dst + T::BYTES + cb * BQ * T::RB, &tmo, cb * T::CB, h, q0, b, bar);
        }
      }
      const uint32_t lv = vec0 + st * 2 * BQ * 4;
      for (int r = lane; r < BQ; r += 32) {  // 4-byte copies that do not stall the lane; zeros past N
        const int row = min(q0 + r, N - 1);
        const uint32_t bytes = q0 + r < N ? 4 : 0;
        cp_async4(lv + 4 * r, lp + row, bytes);
        cp_async4(lv + 4 * (BQ + r), dp + row, bytes);
      }
      cp_async_mbar_arrive(bar);  // arrives when this lane's copies have landed
    }
    return;
  }

  // consumers: warpgroup wg owns kv rows [64 wg, 64 wg + 64) of the CTA's;
  // this thread rows row0 and row0 + 8
  const int wg = warp >> 2, g = lane >> 2, tg = lane & 3;
  const int row0 = blockIdx.x * ROWS + wg * 64 + (warp & 3) * 16 + g;
  uint32_t ka[DP / 16][4], va[DP / 16][4];
  load_frags<DP>(ka, k + b * s.kb + h * s.kh, s.kn, row0, M, D, tg);
  load_frags<DP>(va, v + b * s.vb + h * s.vh, s.vn, row0, M, D, tg);
  fence_regs(ka);
  fence_regs(va);
  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;

  auto wait_full = [&](int it) { mbar_wait(full0 + 8 * (it % STAGES), (it / STAGES) & 1); };
  auto release = [&](int it) {
    if (lane == 0) mbar_arrive(empty0 + 8 * (it % STAGES));
  };
  auto tile = [&](int it) { return base + (it % STAGES) * 2 * T::BYTES; };  // its q2 tile; dO follows
  // S^T = K q2^T and dP^T = V dO^T of the tile in load slot `it`
  auto issue_s = [&](float (&sc)[BQ / 2], float (&dp)[BQ / 2], const uint64_t (&dq)[DP / 16],
                     const uint64_t (&dd)[DP / 16]) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      Wgmma<BQ, 0>::run(sc, ka[kk], dq[kk], kk > 0);
      Wgmma<BQ, 0>::run(dp, va[kk], dd[kk], kk > 0);
    }
  };
  auto s_descs = [&](int it, uint64_t (&dq)[DP / 16], uint64_t (&dd)[DP / 16]) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      dq[kk] = T::kmajor(tile(it), kk);
      dd[kk] = T::kmajor(tile(it) + T::BYTES, kk);
    }
    fence_regs(dq);
    fence_regs(dd);
  };
  // the dO and q2 tiles in load slot `it` as MN-major B operands, and every
  // other operand of the accumulating products pinned before the fence
  auto acc_descs = [&](int it, uint64_t (&mo)[BQ / 16], uint64_t (&mq)[BQ / 16], uint32_t (&pa)[BQ / 16][4],
                       uint32_t (&da)[BQ / 16][4]) {
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      mo[j] = T::mnmajor(tile(it) + T::BYTES, j);
      mq[j] = T::mnmajor(tile(it), j);
    }
    fence_regs(mo);
    fence_regs(mq);
    fence_regs(dka);
    fence_regs(dva);
    fence_regs(pa);
    fence_regs(da);
  };
  // dV += P^T dO and dK += dS^T q2: one product each for every 16 q rows
  auto issue_acc = [&](const uint32_t (&pa)[BQ / 16][4], const uint32_t (&da)[BQ / 16][4],
                       const uint64_t (&mo)[BQ / 16], const uint64_t (&mq)[BQ / 16]) {
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      Wgmma<DP, 1>::run(dva, pa[j], mo[j], 1);
      Wgmma<DP, 1>::run(dka, da[j], mq[j], 1);
    }
  };
  // P^T and dS^T of tile t from its accumulators; lse2 and delta by column
  auto elementwise = [&](const float (&sc)[BQ / 2], const float (&dp)[BQ / 2], uint32_t (&pa)[BQ / 16][4],
                         uint32_t (&da)[BQ / 16][4], int t) {
    const float* lv = vec + (t % STAGES) * 2 * BQ;
    float l2[BQ / 2], dl[BQ / 2];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 lj = *reinterpret_cast<const float2*>(lv + 8 * j + 2 * tg);
      const float2 dj = *reinterpret_cast<const float2*>(lv + BQ + 8 * j + 2 * tg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        l2[4 * j + i] = i & 1 ? lj.y : lj.x;  // lse2 of the column
        dl[4 * j + i] = i & 1 ? dj.y : dj.x;
      }
    }
    const int q0 = tile_start(t, N, BQ);
    const int lo = t * BQ - q0, hi = N - q0;  // q tile columns to keep
    grads<BQ>(sc, dp, l2, dl, lo, hi, tg, scale, pa, da);
  };

  uint32_t pbuf[C::OVL ? 2 : 1][BQ / 16][4], dbuf[C::OVL ? 2 : 1][BQ / 16][4];
  auto& p0 = pbuf[0];
  auto& p1 = pbuf[C::OVL ? 1 : 0];
  auto& d0 = dbuf[0];
  auto& d1 = dbuf[C::OVL ? 1 : 0];
  {  // tile 0
    float sc[BQ / 2], dp[BQ / 2];
    uint64_t dq[DP / 16], dd[DP / 16];
    wait_full(0);
    s_descs(0, dq, dd);
    if (wg == NWG - 1) turn_pass(wg);  // warpgroup 0 issues first
    turn_wait(wg);
    wg_fence();
    issue_s(sc, dp, dq, dd);
    wg_commit();
    turn_pass(wg);
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    elementwise(sc, dp, p0, d0, 0);
  }
  // tile t: S^T and dP^T of tile t with dV and dK of tile t-1 (from pc, dc),
  // then P^T and dS^T of tile t into pn, dn
  auto step = [&](uint32_t (&pc)[BQ / 16][4], uint32_t (&dc)[BQ / 16][4], uint32_t (&pn)[BQ / 16][4],
                  uint32_t (&dn)[BQ / 16][4], int t) {
    float sc[BQ / 2], dp[BQ / 2];
    uint64_t dq[DP / 16], dd[DP / 16], mo[BQ / 16], mq[BQ / 16];
    wait_full(t);
    s_descs(t, dq, dd);
    acc_descs(t - 1, mo, mq, pc, dc);
    turn_wait(wg);
    wg_fence();
    issue_s(sc, dp, dq, dd);
    wg_commit();
    issue_acc(pc, dc, mo, mq);
    wg_commit();
    turn_pass(wg);
    if constexpr (C::OVL)
      wg_wait<1>();  // S^T and dP^T of tile t are in; dV and dK of tile t-1 may still run
    else
      wg_wait<0>();  // one register set: the products of tile t-1 must be done before it is rewritten
    fence_regs(sc);
    fence_regs(dp);
    elementwise(sc, dp, pn, dn, t);
    wg_wait<0>();
    fence_regs(dka);
    fence_regs(dva);
    release(t - 1);
  };
  auto finish = [&](uint32_t (&pc)[BQ / 16][4], uint32_t (&dc)[BQ / 16][4]) {
    uint64_t mo[BQ / 16], mq[BQ / 16];
    acc_descs(ntiles - 1, mo, mq, pc, dc);
    turn_wait(wg);
    wg_fence();
    issue_acc(pc, dc, mo, mq);
    wg_commit();
    if (wg != NWG - 1) turn_pass(wg);  // the last turn
    wg_wait<0>();
    fence_regs(dka);
    fence_regs(dva);
    release(ntiles - 1);
  };
  int t = 1;
  for (; t + 1 < ntiles; t += 2) {
    step(p0, d0, p1, d1, t);
    step(p1, d1, p0, d0, t + 1);
  }
  if (t < ntiles) {
    step(p0, d0, p1, d1, t);
    finish(p1, d1);
  } else {
    finish(p0, d0);
  }

  __nv_bfloat16* dkp = dk + b * s.xb + h * s.xh;
  __nv_bfloat16* dvp = dv + b * s.yb + h * s.yh;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r, col = 8 * j + 2 * tg;
      if (row < M && col < D) {
        *reinterpret_cast<uint32_t*>(dkp + (long long)row * s.xn + col) =
            pack_bf16(dka[4 * j + 2 * r] * dk_scale, dka[4 * j + 2 * r + 1] * dk_scale);
        *reinterpret_cast<uint32_t*>(dvp + (long long)row * s.yn + col) =
            pack_bf16(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
      }
    }
}

// K5: the CTA owns q rows [128 blockIdx.x, +128) of head blockIdx.y and
// loops over kv tiles of BN rows
template <int DP>
__global__ void __launch_bounds__(NTHREADS, 1) flash_bwd_dq_sm90_kernel(
    const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv,
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H, int N, int M, int D, Strides s,
    float scale) {
  using C = Dq<DP>;
  using T = typename C::T;
  constexpr int BN = C::BN;
  extern __shared__ uint8_t smem_raw[];
  // [stage][K tile | V tile], full barriers, empty barriers
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + STAGES * 2 * T::BYTES, empty0 = full0 + 8 * STAGES;
  const int ntiles = (M + BN - 1) / BN;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, NCONSUMER / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NCONSUMER / 32) {  // producer: K and V tiles
    if (lane == 0) {
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty0 + 8 * st, ((it / STAGES) & 1) ^ 1);
        const int kv0 = tile_start(it, M, BN);
        const uint32_t dst = base + st * 2 * T::BYTES, bar = full0 + 8 * st;
        mbar_expect_tx(bar, 2 * T::BYTES);
#pragma unroll
        for (int cb = 0; cb < DP / T::CB; ++cb) {
          tma_load_4d(dst + cb * BN * T::RB, &tmk, cb * T::CB, h, kv0, b, bar);
          tma_load_4d(dst + T::BYTES + cb * BN * T::RB, &tmv, cb * T::CB, h, kv0, b, bar);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows [64 wg, 64 wg + 64) of the CTA's;
  // this thread rows row0 and row0 + 8
  const int wg = warp >> 2, g = lane >> 2, tg = lane & 3;
  const int row0 = blockIdx.x * ROWS + wg * 64 + (warp & 3) * 16 + g;
  uint32_t qa[DP / 16][4], oa[DP / 16][4];
  load_frags<DP>(qa, q + b * s.qb + h * s.qh, s.qn, row0, N, D, tg);
  load_frags<DP>(oa, dout + b * s.ob + h * s.oh, s.on, row0, N, D, tg);
  fence_regs(qa);
  fence_regs(oa);
  float lr[2], dr[2];  // lse2 and delta of rows row0, row0 + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lr[r] = row < N ? lse[(long long)bh * N + row] : 0.f;
    dr[r] = row < N ? delta[(long long)bh * N + row] : 0.f;
  }
  float dqa[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dqa[i] = 0.f;

  auto wait_full = [&](int it) { mbar_wait(full0 + 8 * (it % STAGES), (it / STAGES) & 1); };
  auto release = [&](int it) {
    if (lane == 0) mbar_arrive(empty0 + 8 * (it % STAGES));
  };
  auto tile = [&](int it) { return base + (it % STAGES) * 2 * T::BYTES; };  // its K tile; V follows
  // S = q2 K^T and dP = dO V^T of the tile in load slot `it`
  auto issue_s = [&](float (&sc)[BN / 2], float (&dp)[BN / 2], const uint64_t (&dk_)[DP / 16],
                     const uint64_t (&dv_)[DP / 16]) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      Wgmma<BN, 0>::run(sc, qa[kk], dk_[kk], kk > 0);
      Wgmma<BN, 0>::run(dp, oa[kk], dv_[kk], kk > 0);
    }
  };
  auto s_descs = [&](int it, uint64_t (&dk_)[DP / 16], uint64_t (&dv_)[DP / 16]) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      dk_[kk] = T::kmajor(tile(it), kk);
      dv_[kk] = T::kmajor(tile(it) + T::BYTES, kk);
    }
    fence_regs(dk_);
    fence_regs(dv_);
  };
  // the K tile in load slot `it` as the MN-major B operand, and every other
  // operand of dQ's product pinned before the fence
  auto acc_descs = [&](int it, uint64_t (&mk)[BN / 16], uint32_t (&da)[BN / 16][4]) {
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) mk[j] = T::mnmajor(tile(it), j);
    fence_regs(mk);
    fence_regs(dqa);
    fence_regs(da);
  };
  // dQ += dS K: one product for every 16 kv rows
  auto issue_acc = [&](const uint32_t (&da)[BN / 16][4], const uint64_t (&mk)[BN / 16]) {
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) Wgmma<DP, 1>::run(dqa, da[j], mk[j], 1);
  };
  // dS of tile t from its accumulators; lse2 and delta by row. The P
  // fragments are not needed: they land in a scratch set
  auto elementwise = [&](const float (&sc)[BN / 2], const float (&dp)[BN / 2], uint32_t (&da)[BN / 16][4], int t) {
    float l2[BN / 2], dl[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      l2[i] = lr[(i >> 1) & 1];  // lse2 of the row
      dl[i] = dr[(i >> 1) & 1];
    }
    const int kv0 = tile_start(t, M, BN);
    const int lo = t * BN - kv0, hi = M - kv0;  // kv tile columns to keep
    uint32_t pa[BN / 16][4];
    grads<BN>(sc, dp, l2, dl, lo, hi, tg, scale, pa, da);
  };

  uint32_t dbuf[C::OVL ? 2 : 1][BN / 16][4];
  auto& d0 = dbuf[0];
  auto& d1 = dbuf[C::OVL ? 1 : 0];
  {  // tile 0
    float sc[BN / 2], dp[BN / 2];
    uint64_t dk_[DP / 16], dv_[DP / 16];
    wait_full(0);
    s_descs(0, dk_, dv_);
    if (wg == NWG - 1) turn_pass(wg);  // warpgroup 0 issues first
    turn_wait(wg);
    wg_fence();
    issue_s(sc, dp, dk_, dv_);
    wg_commit();
    turn_pass(wg);
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    elementwise(sc, dp, d0, 0);
  }
  // tile t: S and dP of tile t with dQ of tile t-1 (from dc), then dS of tile t into dn
  auto step = [&](uint32_t (&dc)[BN / 16][4], uint32_t (&dn)[BN / 16][4], int t) {
    float sc[BN / 2], dp[BN / 2];
    uint64_t dk_[DP / 16], dv_[DP / 16], mk[BN / 16];
    wait_full(t);
    s_descs(t, dk_, dv_);
    acc_descs(t - 1, mk, dc);
    turn_wait(wg);
    wg_fence();
    issue_s(sc, dp, dk_, dv_);
    wg_commit();
    issue_acc(dc, mk);
    wg_commit();
    turn_pass(wg);
    if constexpr (C::OVL)
      wg_wait<1>();  // S and dP of tile t are in; dQ of tile t-1 may still run
    else
      wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    elementwise(sc, dp, dn, t);
    wg_wait<0>();
    fence_regs(dqa);
    release(t - 1);
  };
  auto finish = [&](uint32_t (&dc)[BN / 16][4]) {
    uint64_t mk[BN / 16];
    acc_descs(ntiles - 1, mk, dc);
    turn_wait(wg);
    wg_fence();
    issue_acc(dc, mk);
    wg_commit();
    if (wg != NWG - 1) turn_pass(wg);  // the last turn
    wg_wait<0>();
    fence_regs(dqa);
    release(ntiles - 1);
  };
  int t = 1;
  for (; t + 1 < ntiles; t += 2) {
    step(d0, d1, t);
    step(d1, d0, t + 1);
  }
  if (t < ntiles) {
    step(d0, d1, t);
    finish(d1);
  } else {
    finish(d0);
  }

  __nv_bfloat16* dqp = dq + b * s.xb + h * s.xh;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r, col = 8 * j + 2 * tg;
      if (row < N && col < D)
        *reinterpret_cast<uint32_t*>(dqp + (long long)row * s.xn + col) =
            pack_bf16(dqa[4 * j + 2 * r], dqa[4 * j + 2 * r + 1]);
    }
}

constexpr int box_d(int D) { return D <= 16 ? 16 : D <= 32 ? 32 : 64; }

template <int DP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int B, int H, int N, int M, int D, const Strides& s, float scale, float dk_scale,
               cudaStream_t st) {
  using C = Dkv<DP>;
  CUtensorMap tq, to;
  int err = encode(&tq, q, B, H, N, D, s.qb, s.qh, s.qn, box_d(D), C::BQ);
  if (!err) err = encode(&to, dout, B, H, N, D, s.ob, s.oh, s.on, box_d(D), C::BQ);
  if (err) return err;
  static const cudaError_t attr =
      cudaFuncSetAttribute(flash_bwd_dkv_sm90_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((M + ROWS - 1) / ROWS, B * H);
  flash_bwd_dkv_sm90_kernel<DP><<<grid, NTHREADS, C::SMEM, st>>>(
      tq, to, static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, N, M, D, s, scale, dk_scale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
              void* dq, int B, int H, int N, int M, int D, const Strides& s, float scale, cudaStream_t st) {
  using C = Dq<DP>;
  CUtensorMap tk, tv;
  int err = encode(&tk, k, B, H, M, D, s.kb, s.kh, s.kn, box_d(D), C::BN);
  if (!err) err = encode(&tv, v, B, H, M, D, s.vb, s.vh, s.vn, box_d(D), C::BN);
  if (err) return err;
  static const cudaError_t attr =
      cudaFuncSetAttribute(flash_bwd_dq_sm90_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((N + ROWS - 1) / ROWS, B * H);
  flash_bwd_dq_sm90_kernel<DP><<<grid, NTHREADS, C::SMEM, st>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dq), H, N, M, D, s, scale);
  return (int)cudaGetLastError();
}

bool shapes_ok(int is_bf16, int N, int M, int D) { return is_bf16 && D >= 8 && D <= 128 && D % 8 == 0 && N >= 1 && M >= 1; }

}  // namespace

// K4 on bf16 tensors (is_bf16 must be 1: fp32 K4 is flash_attention_bwd.cu's).
// q: the pre-scaled q2. strides: 18 element strides (b, h, n) of q2, k, v,
// dO, dk, dv. lse and delta: contiguous fp32 [B, H, N]. scale: 1/sqrt(d);
// dk_scale: 1/(scale * log2(e)). Returns a cudaError_t: the tensor maps'
// encoding, then cudaGetLastError() after the launch.
extern "C" int flash_bwd_dkv(int is_bf16, const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int B, int H, int N, int M,
                             int D, const long long* strides, float scale, float dk_scale, void* stream) {
  if (!shapes_ok(is_bf16, N, M, D)) return (int)cudaErrorInvalidValue;
  Strides s;
  memcpy(&s, strides, sizeof(s));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto* ll = static_cast<const float*>(lse);
  auto* dd = static_cast<const float*>(delta);
  if (D <= 16) return launch_dkv<16>(q, k, v, dout, ll, dd, dk, dv, B, H, N, M, D, s, scale, dk_scale, st);
  if (D <= 32) return launch_dkv<32>(q, k, v, dout, ll, dd, dk, dv, B, H, N, M, D, s, scale, dk_scale, st);
  if (D <= 64) return launch_dkv<64>(q, k, v, dout, ll, dd, dk, dv, B, H, N, M, D, s, scale, dk_scale, st);
  return launch_dkv<128>(q, k, v, dout, ll, dd, dk, dv, B, H, N, M, D, s, scale, dk_scale, st);
}

// K5 on bf16 tensors, as flash_bwd_dkv; strides: (b, h, n) of q2, k, v, dO,
// dq (the last triple unused).
extern "C" int flash_bwd_dq(int is_bf16, const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int B, int H, int N, int M, int D,
                            const long long* strides, float scale, void* stream) {
  if (!shapes_ok(is_bf16, N, M, D)) return (int)cudaErrorInvalidValue;
  Strides s;
  memcpy(&s, strides, sizeof(s));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto* ll = static_cast<const float*>(lse);
  auto* dd = static_cast<const float*>(delta);
  if (D <= 16) return launch_dq<16>(q, k, v, dout, ll, dd, dq, B, H, N, M, D, s, scale, st);
  if (D <= 32) return launch_dq<32>(q, k, v, dout, ll, dd, dq, B, H, N, M, D, s, scale, st);
  if (D <= 64) return launch_dq<64>(q, k, v, dout, ll, dd, dq, B, H, N, M, D, s, scale, st);
  return launch_dq<128>(q, k, v, dout, ll, dd, dq, B, H, N, M, D, s, scale, st);
}
