// K4 and K5 in fp32: flash-attention backward, non-causal, unmasked, on
// Hopper (sm_90a) with 3xTF32 wgmma and a TMA ring. bf16 K4 and K5 are
// flash_bwd_sm90.cu's.
//
// K4 `flash_bwd_dkv` replaces the Pallas TPU kernel `_flash_bwd_dkv_kernel`
// (audioldm_tpu/kernels/flash_attention.py:237, launched at :313) and K5
// `flash_bwd_dq` replaces `_flash_bwd_dq_kernel` (:264, launched at :340).
// Neither writes the [N, M] matrices to memory: from the forward's
// q2 = q * log2(e)/sqrt(d) (pre-scaled by the wrapper, as the TPU kernels
// get it) each recomputes
//   P  = exp2(q2 k^T - lse2)                        (lse2 from K3)
//   dP = dO v^T
//   dS = P o (dP - delta) * scale                   (delta = rowsum(dO o O), given)
// and accumulates  dV = P^T dO,  dK = dS^T q2  (K4)  or  dQ = dS k  (K5)
// in fp32; K4 multiplies dS^T q2 by dk_scale = 1/(scale * log2(e)) as it
// stores dK (flash_attention.py:251-260, :274-281).
//
// What bounds them on an H100: at [2, 8, 4096, 16] (fp32 LoRA training's
// level-0 self-attention) K4 does four products of 4.3 GFLOP (S^T, dP^T,
// dV, dK), K5 three (S, dP, dQ): 0.513 and 0.385 ms of fp32 FMA at 67
// TFLOP/s, which no SIMT kernel can beat (the first design, a thread a kv
// or q row with FFMA, took 1.127 and 0.952 ms), and 0.208 and 0.156 ms as
// three TF32 tensor-core products a term at 495 TFLOP/s. The design (3xTF32
// on wgmma, as the fp32 K1 in flash_attention.cu):
//   - every product is a_hi b_hi + a_lo b_hi + a_hi b_lo in fp32
//     accumulators (the lo*lo term, ~2^-20 relative, dropped), the lo
//     products issued first; hi = x truncated to tf32, lo = x - hi
//     (sm90.cuh's `split`);
//   - a CTA owns 128 rows (K4 kv rows, K5 q rows): two consumer warpgroups
//     of 64, one TMA warp and three transform warps, and streams the other
//     side in tiles of T rows (K4: q2 and dO; K5: K and V) by TMA into a
//     ring of stages with full, ready and empty mbarriers. A tile lands as
//     boxes of 4 columns (4-D fp32 maps, no swizzle): [d/4][row][4], a
//     K-major operand of no-swizzle core matrices as it lies;
//   - S (K4: S^T = K q2^T; K5: S = q2 K^T) and dP (dP^T = V dO^T; dP = dO
//     V^T) read the landed tiles as B: the tensor core reads an fp32 value's
//     tf32 part, which is its truncation, so a tile as landed is its own hi
//     plane, and the transform warps write only its lo plane beside it. The
//     owned rows (K4: K and V; K5: q2 and dO) are split once into hi and lo
//     planes in shared memory, taken as A by descriptor;
//   - dV += P^T dO, dK += dS^T q2 and dQ += dS K need B with K = the
//     streamed rows, and tf32 wgmma has no transposed B (sm90.cuh). So the
//     transform warps also write the transposed hi and lo planes ([d][row],
//     no-swizzle K-major core matrices 144 bytes apart along the rows, so
//     that their stores hit every bank group: K4 dO^T and q2^T, K5 K^T),
//     with the rows permuted within each group of 8 (0, 2, 4, 6, 1, 3, 5,
//     7): P^T, dS^T and dS then pass from the S and dP accumulators
//     straight into the A fragments with no shuffle, as the fp32 K1's P V
//     does. P and dS are split in registers. At d = 16 the lo plane lies
//     right after the hi one, so one product of N = 2D takes the hi
//     fragments against both: two products for each 8 streamed rows, not
//     three;
//   - the tensor core's adds into one accumulator over every tile would
//     miss the fp32 bound (as in K1), so each tile's dV, dK or dQ is a
//     fresh tensor-core sum, waited for and added to the fp32 running sum
//     in registers. K4 issues dV's and waits for it before it splits dS,
//     whose lo fragments then take P's registers: that leaves the
//     registers for 64-row q tiles at d = 16;
//   - lse2 and delta: K5 holds its rows' in registers; K4 needs them per
//     column, and the TMA warp copies the tile's into the stage with 4-byte
//     cp.async that arrive on the stage's full barrier;
//   - a ragged last tile is read as the whole tile that ends at the last
//     row (zero-filled past the end when the axis is shorter than a tile),
//     and its columns that the previous tile already covered are masked to
//     P = 0 and dS = 0 (a whole tile skips the mask). No atomics: the same
//     inputs give the same bits.
// Tiles: T = 64 at d = 16, 32 at d = 32, 16 above. Stages: 4 at d <= 32, 2
// at d = 64, 1 at d = 128, where a CTA owns 64 rows (one consumer
// warpgroup: the owned planes take 128 KB) and each row tile takes two
// CTAs, one for each half of the output columns (both compute S and dP).
// Grid: ceil(rows / 128) x (B * H) x D / DV; 384 threads (256 at d = 128),
// one CTA an SM. What the variants measured (tools/flash_bwd_f32_variants.py):
// the products set the pace, the elementwise work and the transform add
// little on top of them, and one transform warp instead of three loses.
//
// Requires D % 8 == 0, D <= 128, 16-byte aligned tensors and (b, h, n)
// strides that are multiples of 8 elements (the wrapper pads and copies to
// get them); lse2 and delta are contiguous fp32 [B, H, N].

#include <math.h>
#include <string.h>

#include "sm90.cuh"
#include "sm90_host.cuh"

namespace {

using namespace sm90;

// element strides (b, h, n) of q2, k, v, dO and of the outputs (K4: dk, dv;
// K5: dq, unused)
struct Strides {
  long long qb, qh, qn, kb, kh, kn, vb, vh, vn, ob, oh, on, xb, xh, xn, yb, yh, yn;
};

// what a CTA reads besides its two tensor maps: the owned rows (K4: k, v;
// K5: q2, dO), lse2 and delta, the outputs (K4: dk, dv; K5: dq)
struct Args {
  const float* own_a;
  const float* own_b;
  long long ab, ah, an, bb, bh, bn;  // (b, h, n) strides of own_a, own_b
  const float* lse;
  const float* delta;
  float* out1;
  float* out2;
  long long o1b, o1h, o1n, o2b, o2h, o2n;
  int H, NR, NS, D;  // heads, owned rows, streamed rows, head dim
  float scale, out1_scale;
};

// DKV: K4 (owns kv rows, streams q2 and dO), else K5 (owns q rows, streams K and V)
template <int DP, bool DKV>
struct Cfg {
  static constexpr int T = DP == 16 ? 64 : DP == 32 ? 32 : 16;                // streamed rows a tile
  static constexpr int NWG = DP == 128 ? 1 : 2;                                // consumer warpgroups, 64 rows each
  static constexpr int ROWS = 64 * NWG;                                        // owned rows a CTA
  static constexpr int NCONSUMER = 128 * NWG;
  static constexpr int NTRANSFORM = 96;                                        // three transform warps
  static constexpr int NTHREADS = NCONSUMER + 32 + NTRANSFORM;                 // and one TMA warp
  static constexpr int DV = DP < 64 ? DP : 64;                                 // output columns a CTA
  static constexpr int STAGES = DP <= 32 ? 4 : DP == 64 ? 2 : 1;
  static constexpr bool WIDE = DV == 16;        // the hi products as one of N = 2 DV
  static constexpr int NT = DKV ? 2 : 1;        // streamed tensors that are also transposed
  static constexpr int PLANE = T * DP * 4;      // bytes of a streamed tile's plane
  // a transposed plane: [d/8][k/4] core matrices of 8 d rows x 16 bytes,
  // CM = 144 bytes apart along k (16 more than a core matrix: the transform
  // warps' stores of one d row to 8 core matrices hit 8 bank groups)
  static constexpr int CM = 144, SBO = (T / 4) * CM, TPLANE = (DV / 8) * SBO;
  // a stage: tensor x's tile at x TILE (as landed, which the tensor core
  // reads as its hi plane, then its lo plane), then the transposed planes,
  // tensor x's at TR + 2 x TPLANE (hi, then lo)
  static constexpr int TILE = 2 * PLANE, TR = 2 * TILE, STAGE = TR + 2 * NT * TPLANE;
  static_assert(STAGE % 1024 == 0, "TMA destinations 1024-byte aligned");
  static constexpr int VEC = DKV ? 2 * T * 4 : 0;      // a stage's lse2 and delta (K4)
  static constexpr int OWN = 64 * DP * 4;              // an owned plane: 64 rows
  static constexpr int SMEM = 1024 + STAGES * (STAGE + VEC) + NWG * 4 * OWN + 3 * 8 * STAGES;
  static_assert(SMEM <= 232448, "shared memory of a CTA");
};

// offset in floats of element (row, k) of a no-swizzle K-major operand with
// K extent KEXT: [row/8][k/4] core matrices of 8 rows x 16 bytes
template <int KEXT>
__device__ __forceinline__ int core_off(int row, int k) {
  return ((row >> 3) * (KEXT / 4) + (k >> 2)) * 32 + (row & 7) * 4 + (k & 3);
}

// first row of tile t of width bt over n rows: the ragged last tile ends at
// row n (it starts at 0 when n < bt)
__device__ __forceinline__ int tile_start(int t, int n, int bt) { return min(t * bt, max(n - bt, 0)); }

__device__ __forceinline__ float4 split4(float4 x, float4& lo) {
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
  return make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]), __uint_as_float(h[3]));
}

__device__ __forceinline__ float comp(const float4& v, int e) { return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w; }

template <int DP, bool DKV>
__device__ __forceinline__ void bwd(const CUtensorMap* tma, const CUtensorMap* tmb, const Args& a) {
  using C = Cfg<DP, DKV>;
  constexpr int T = C::T, S = C::STAGES, DV = C::DV, CW = C::NCONSUMER / 32;  // warp CW: TMA; the ones after: transform
  extern __shared__ uint8_t smem_raw[];
  // [stage][tile a | tile b | transposed planes], [stage][lse2 | delta], owned planes, full, ready and empty barriers
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* const fbase = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)));
  const uint32_t vec0 = base + S * C::STAGE, own0 = vec0 + S * C::VEC;
  const uint32_t full0 = own0 + C::NWG * 4 * C::OWN, ready0 = full0 + 8 * S, empty0 = ready0 + 8 * S;
  const int ntiles = (a.NS + T - 1) / T;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int dv0 = blockIdx.z * DV;  // this CTA's output columns [dv0, dv0 + DV)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(full0 + 8 * st, DKV ? 1 + 32 : 1);  // K4: the expect_tx of lane 0, then every lane's copies
      mbar_init(ready0 + 8 * st, C::NTRANSFORM);
      mbar_init(empty0 + 8 * st, CW);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CW) {  // the TMA warp: streamed tile `it` into stage it % S
    const float* const lp = a.lse + (long long)bh * a.NS;
    const float* const dp = a.delta + (long long)bh * a.NS;
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % S;
      if (it >= S) mbar_wait(empty0 + 8 * st, ((it / S) & 1) ^ 1);
      const int s0 = tile_start(it, a.NS, T);
      const uint32_t dst = base + st * C::STAGE, bar = full0 + 8 * st;
      if (lane == 0) {
        const int nbox = a.D / 4;  // boxes of 4 columns; the columns past D stay for the transform to zero
        mbar_expect_tx(bar, 2 * nbox * T * 16);
        for (int c = 0; c < nbox; ++c) {
          tma_load_4d(dst + c * T * 16, tma, 4 * c, h, s0, b, bar);
          tma_load_4d(dst + C::TILE + c * T * 16, tmb, 4 * c, h, s0, b, bar);
        }
      }
      if constexpr (DKV) {  // lse2 and delta of the tile's q rows; zeros past N
        const uint32_t lv = vec0 + st * C::VEC;
        for (int r = lane; r < T; r += 32) {
          const int row = min(s0 + r, a.NS - 1);
          const uint32_t bytes = s0 + r < a.NS ? 4 : 0;
          cp_async4(lv + 4 * r, lp + row, bytes);
          cp_async4(lv + 4 * (T + r), dp + row, bytes);
        }
        cp_async_mbar_arrive(bar);  // arrives when this lane's copies have landed
      }
    }
    return;
  }

  if (warp > CW) {  // the transform warps: lo planes of the landed tiles, and the transposed planes
    constexpr int CB = DP / 4, NB = (T / 4) * CB;  // 4 x 4 blocks of a tile
    const int ttid = threadIdx.x - C::NCONSUMER - 32;
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % S;
      mbar_wait(full0 + 8 * st, (it / S) & 1);
      float* const stg = fbase + st * C::STAGE / 4;
      // a thread takes a 4 x 4 block of tensor x: rows r0 + 2 m (m < 4, r0 =
      // 8 j + par) of columns [4 c, 4 c + 4). In the transposed planes they
      // are k = 8 j + 4 par + m of group j. Its i-th row is m = (i + sh) & 3,
      // so that a quarter warp's loads and stores hit 8 bank groups
      for (int idx = ttid; idx < 2 * NB; idx += C::NTRANSFORM) {
        const int x = idx >= NB, blk = idx - x * NB;
        const int rq = blk % (T / 4), c = blk / (T / 4), r0 = 8 * (rq >> 1) + (rq & 1);
        const int sh = ((rq >> 1) + 2 * (c & 1)) & 3;
        float4* const hi = reinterpret_cast<float4*>(stg + x * C::TILE / 4) + c * T;
        float4* const lo = reinterpret_cast<float4*>(stg + x * C::TILE / 4 + C::PLANE / 4) + c * T;
        const bool in = 4 * c < a.D;  // columns past D: not loaded, zeroed here
        float4 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + 2 * ((i + sh) & 3);
          v[i] = in ? hi[r] : make_float4(0.f, 0.f, 0.f, 0.f);
          if (!in) hi[r] = v[i];
          split4(v[i], lo[r]);
        }
        if (x < C::NT && 4 * c >= dv0 && 4 * c < dv0 + DV) {
          // back to row order: w[m] = row r0 + 2 m
          float4 w[4] = {v[0], v[1], v[2], v[3]};
          if (sh & 1) {
            const float4 t = w[3];
            w[3] = w[2];
            w[2] = w[1];
            w[1] = w[0];
            w[0] = t;
          }
          if (sh & 2) {
            float4 t = w[0];
            w[0] = w[2];
            w[2] = t;
            t = w[1];
            w[1] = w[3];
            w[3] = t;
          }
          float* const thi = stg + (C::TR + 2 * x * C::TPLANE) / 4;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = 4 * c + e - dv0;
            float4* const t = reinterpret_cast<float4*>(thi + ((d >> 3) * C::SBO + rq * C::CM) / 4 + (d & 7) * 4);
            t[0] = split4(make_float4(comp(w[0], e), comp(w[1], e), comp(w[2], e), comp(w[3], e)), t[C::TPLANE / 16]);
          }
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // wgmma (the async proxy) reads them
      mbar_arrive(ready0 + 8 * st);
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the CTA's; this
  // thread rows row0 and row0 + 8
  const int wg = warp >> 2, g = lane >> 2, tg = lane & 3;
  const int rbase = blockIdx.x * C::ROWS + wg * 64, row0 = rbase + (warp & 3) * 16 + g;
  const float* const pa = a.own_a + b * a.ab + h * a.ah;
  const float* const pb = a.own_b + b * a.bb + h * a.bh;
  const uint32_t ownp = own0 + wg * 4 * C::OWN;  // this warpgroup's planes: a hi, a lo, b hi, b lo
  {
    float* const op = fbase + (ownp - base) / 4;
    for (int idx = threadIdx.x - 128 * wg; idx < 64 * DP; idx += 128) {
      const int r = idx / DP, col = idx % DP, row = rbase + r, off = core_off<DP>(r, col);
      const bool ok = row < a.NR && col < a.D;
      uint32_t hi, lo;
      split(ok ? pa[(long long)row * a.an + col] : 0.f, hi, lo);
      op[off] = __uint_as_float(hi);
      op[C::OWN / 4 + off] = __uint_as_float(lo);
      split(ok ? pb[(long long)row * a.bn + col] : 0.f, hi, lo);
      op[2 * C::OWN / 4 + off] = __uint_as_float(hi);
      op[3 * C::OWN / 4 + off] = __uint_as_float(lo);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup's planes are written
  }
  float lr[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f};  // K5: lse2 and delta of rows row0, row0 + 8
  if constexpr (!DKV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lr[r] = row < a.NR ? a.lse[(long long)bh * a.NR + row] : 0.f;
      dr[r] = row < a.NR ? a.delta[(long long)bh * a.NR + row] : 0.f;
    }
  }

  // the streamed tile x (0: a, 1: b) of tile `it`, hi or lo plane, as B of
  // S or dP (n = its rows, k = d columns [8 kk, 8 kk + 8))
  auto t_desc = [&](int it, int x, int kk, int lo) -> uint64_t {
    return desc(base + (it % S) * C::STAGE + x * C::TILE + lo * C::PLANE + 2 * kk * T * 16, T * 16, 128, 0);
  };
  // tensor x's owned plane (hi or lo) as A, d columns [8 kk, 8 kk + 8)
  auto o_desc = [&](int x, int kk, int lo) -> uint64_t {
    return desc(ownp + (2 * x + lo) * C::OWN + kk * 256, 128, (DP / 4) * 128, 0);
  };
  // tensor x's transposed hi plane of tile `it` as B (n = d, k = the
  // streamed rows of group j); its lo plane follows at + TPLANE
  auto tr_desc = [&](int it, int x, int j, int lo) -> uint64_t {
    return desc(base + (it % S) * C::STAGE + C::TR + (2 * x + lo) * C::TPLANE + j * 2 * C::CM, C::CM, C::SBO, 0);
  };
  // S (x = 0) or dP (x = 1) of tile `it`, d columns [8 kk, 8 kk + 8): the
  // two lo products, the first of the tile's overwriting, or the hi one
  auto s_products = [&](float (&acc)[T / 2], int it, int x, int hi, int kk) {
    if (hi) {
      WgmmaTF32SS<T>::run(acc, o_desc(x, kk, 0), t_desc(it, x, kk, 0), 1);
    } else {
      WgmmaTF32SS<T>::run(acc, o_desc(x, kk, 1), t_desc(it, x, kk, 0), kk > 0);
      WgmmaTF32SS<T>::run(acc, o_desc(x, kk, 0), t_desc(it, x, kk, 1), 1);
    }
  };
  // the A fragments of accumulator x's elements: element 4j + i becomes
  // fragment [j][i] with 1 and 2 swapped, split into hi and lo
  auto frags = [&](const float (&x)[T / 2], uint32_t (&fh)[T / 8][4], uint32_t (&fl)[T / 8][4]) {
#pragma unroll
    for (int j = 0; j < T / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = i == 1 ? 2 : i == 2 ? 1 : i;
        split(x[4 * j + i], fh[j][f], fl[j][f]);
      }
  };
  // acc += a fresh sum of tile `it`'s product of the A fragments (P^T,
  // dS^T or dS) with tensor x's transposed planes, issued and waited for:
  // lo products first. WIDE (d = 16): the a_lo b_hi products into f,
  // [a_hi b_hi | a_hi b_lo] into fw (N = 2 DV), the descriptors pinned; the
  // small sums added first
  auto accumulate = [&](float (&acc)[DV / 2], uint32_t (&ah)[T / 8][4], uint32_t (&al)[T / 8][4], int it, int x) {
    float f[DV / 2], fw[C::WIDE ? DV : 1];
    uint64_t dt[C::WIDE ? T / 8 : 1];
    if constexpr (C::WIDE) {
#pragma unroll
      for (int j = 0; j < T / 8; ++j) dt[j] = tr_desc(it, x, j, 0);
    }
    fence_regs(dt);
    fence_regs(ah);
    fence_regs(al);
    fence_regs(f);
    fence_regs(fw);
    wg_fence();
    if constexpr (C::WIDE) {
#pragma unroll
      for (int j = 0; j < T / 8; ++j) {  // f and fw in turn: two independent accumulator chains
        WgmmaTF32<DV>::run(f, al[j], dt[j], j > 0);
        WgmmaTF32<2 * DV>::run(fw, ah[j], dt[j], j > 0);
      }
    } else {
#pragma unroll
      for (int j = 0; j < T / 8; ++j) {
        WgmmaTF32<DV>::run(f, al[j], tr_desc(it, x, j, 0), j > 0);
        WgmmaTF32<DV>::run(f, ah[j], tr_desc(it, x, j, 1), 1);
      }
#pragma unroll
      for (int j = 0; j < T / 8; ++j) WgmmaTF32<DV>::run(f, ah[j], tr_desc(it, x, j, 0), 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(f);
    fence_regs(fw);
    fence_regs(ah);
    fence_regs(al);
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) {
      if constexpr (C::WIDE)
        acc[i] += fw[i] + (fw[i + DV / 2] + f[i]);
      else
        acc[i] += f[i];
    }
  };

  // running sums in fp32 registers: acc1 K4 dK, K5 dQ; acc2 K4 dV
  float acc1[DV / 2], acc2[DKV ? DV / 2 : 1];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DKV ? DV / 2 : 1); ++i) acc2[i] = 0.f;
  const float* const vec = fbase + (vec0 - base) / 4;

  for (int t = 0; t < ntiles; ++t) {
    const int st = t % S;
    if constexpr (DKV) mbar_wait(full0 + 8 * st, (t / S) & 1);  // K4 reads the stage's lse2 and delta
    mbar_wait(ready0 + 8 * st, (t / S) & 1);
    float sc[T / 2], dp[T / 2];
    wg_fence();
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)  // S and dP in turn: two independent accumulator chains
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        s_products(sc, t, 0, hi, kk);
        s_products(dp, t, 1, hi, kk);
      }
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    // P and dS of the accumulators' elements (element i: row g + 8 ((i >> 1)
    // & 1), column 8 (i >> 2) + 2 tg + (i & 1) of the tile); the columns
    // outside [lo, hi) get P = dS = 0
    const int s0 = tile_start(t, a.NS, T);
    const int lo = t * T - s0, hi = a.NS - s0;  // tile columns to keep
    const bool whole = lo <= 0 && hi >= T;
    const float* const lv = vec + st * C::VEC / 4;
#pragma unroll
    for (int i = 0; i < T / 2; ++i) {
      float l2, dl;
      if constexpr (DKV) {  // K4: by column (q)
        const int col = 8 * (i >> 2) + 2 * tg + (i & 1);
        l2 = lv[col];
        dl = lv[T + col];
      } else {
        l2 = lr[(i >> 1) & 1];
        dl = dr[(i >> 1) & 1];  // K5: delta of the q row
      }
      const float p = ex2(sc[i] - l2);
      const float ds = p * (dp[i] - dl) * a.scale;
      sc[i] = p;
      dp[i] = ds;
    }
    if (!whole) {
#pragma unroll
      for (int i = 0; i < T / 2; ++i) {
        const int col = 8 * (i >> 2) + 2 * tg + (i & 1);
        if (col < lo || col >= hi) sc[i] = dp[i] = 0.f;  // masked column
      }
    }
    // K4: dV += P^T dO, then (its lo fragments in the registers of P's)
    // dK += dS^T q2; K5: dQ += dS K
    uint32_t fh[T / 8][4], fl[T / 8][4];
    if constexpr (DKV) {
      frags(sc, fh, fl);
      accumulate(acc2, fh, fl, t, 1);
    }
    frags(dp, fh, fl);
    accumulate(acc1, fh, fl, t, 0);
    if (lane == 0) mbar_arrive(empty0 + 8 * st);  // this warp is done with the stage
  }

  float* const o1 = a.out1 + b * a.o1b + h * a.o1h;
  float* const o2 = a.out2 + b * a.o2b + h * a.o2h;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r, col = dv0 + 8 * j + 2 * tg;
      if (row < a.NR && col < a.D) {
        *reinterpret_cast<float2*>(o1 + (long long)row * a.o1n + col) =
            make_float2(acc1[4 * j + 2 * r] * a.out1_scale, acc1[4 * j + 2 * r + 1] * a.out1_scale);
        if constexpr (DKV)
          *reinterpret_cast<float2*>(o2 + (long long)row * a.o2n + col) =
              make_float2(acc2[4 * j + 2 * r], acc2[4 * j + 2 * r + 1]);
      }
    }
}

// fp32 K4: the CTA owns kv rows [ROWS blockIdx.x, +ROWS) of head blockIdx.y
// and streams q tiles
template <int DP>
__global__ void __launch_bounds__(Cfg<DP, true>::NTHREADS, 1) flash_bwd_dkv_f32(
    const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmo, const __grid_constant__ Args a) {
  bwd<DP, true>(&tmq, &tmo, a);
}

// fp32 K5: the CTA owns q rows [ROWS blockIdx.x, +ROWS) of head blockIdx.y
// and streams kv tiles
template <int DP>
__global__ void __launch_bounds__(Cfg<DP, false>::NTHREADS, 1) flash_bwd_dq_f32(
    const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv, const __grid_constant__ Args a) {
  bwd<DP, false>(&tmk, &tmv, a);
}

// the streamed tensors sa, sb ([B, H, NS, D], strides (b, h, n) in ss*) as
// maps of boxes of 4 columns x T rows, then the launch
template <int DP, bool DKV>
int launch(const void* sa, const long long* ssa, const void* sb, const long long* ssb, const Args& a, int B,
           cudaStream_t st) {
  using C = Cfg<DP, DKV>;
  void (*kern)(const CUtensorMap, const CUtensorMap, const Args) = DKV ? flash_bwd_dkv_f32<DP> : flash_bwd_dq_f32<DP>;
  static const cudaError_t attr = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap ta, tb;
  int err = encode(&ta, sa, B, a.H, a.NS, a.D, ssa[0], ssa[1], ssa[2], 4, C::T, 4, false);
  if (!err) err = encode(&tb, sb, B, a.H, a.NS, a.D, ssb[0], ssb[1], ssb[2], 4, C::T, 4, false);
  if (err) return err;
  const dim3 grid((a.NR + C::ROWS - 1) / C::ROWS, B * a.H, DP / C::DV);
  kern<<<grid, C::NTHREADS, C::SMEM, st>>>(ta, tb, a);
  return (int)cudaGetLastError();
}

template <bool DKV>
int launch_d(const void* sa, const long long* ssa, const void* sb, const long long* ssb, const Args& a, int B,
             cudaStream_t st) {
  if (a.D <= 16) return launch<16, DKV>(sa, ssa, sb, ssb, a, B, st);
  if (a.D <= 32) return launch<32, DKV>(sa, ssa, sb, ssb, a, B, st);
  if (a.D <= 64) return launch<64, DKV>(sa, ssa, sb, ssb, a, B, st);
  return launch<128, DKV>(sa, ssa, sb, ssb, a, B, st);
}

bool shapes_ok(int is_bf16, int N, int M, int D) { return !is_bf16 && D >= 8 && D <= 128 && D % 8 == 0 && N >= 1 && M >= 1; }

}  // namespace

// fp32 K4 (is_bf16 must be 0: bf16 K4 is flash_bwd_sm90.cu's). q: the
// pre-scaled q2. strides: 18 element strides (b, h, n) of q2, k, v, dO, dk,
// dv. lse and delta: contiguous fp32 [B, H, N]. scale: 1/sqrt(d); dk_scale:
// 1/(scale * log2(e)). Returns a cudaError_t: the tensor maps' encoding,
// then cudaGetLastError() after the launch.
extern "C" int flash_bwd_dkv(int is_bf16, const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int B, int H, int N,
                             int M, int D, const long long* strides, float scale, float dk_scale,
                             void* stream) {
  if (!shapes_ok(is_bf16, N, M, D)) return (int)cudaErrorInvalidValue;
  Strides s;
  memcpy(&s, strides, sizeof(s));
  const Args a{static_cast<const float*>(k), static_cast<const float*>(v), s.kb, s.kh, s.kn, s.vb, s.vh, s.vn,
               static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dk),
               static_cast<float*>(dv), s.xb, s.xh, s.xn, s.yb, s.yh, s.yn, H, M, N, D, scale, dk_scale};
  const long long sq[3] = {s.qb, s.qh, s.qn}, so[3] = {s.ob, s.oh, s.on};
  return launch_d<true>(q, sq, dout, so, a, B, reinterpret_cast<cudaStream_t>(stream));
}

// fp32 K5, as flash_bwd_dkv; strides: (b, h, n) of q2, k, v, dO, dq (the
// last triple unused).
extern "C" int flash_bwd_dq(int is_bf16, const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int B, int H, int N, int M, int D,
                            const long long* strides, float scale, void* stream) {
  if (!shapes_ok(is_bf16, N, M, D)) return (int)cudaErrorInvalidValue;
  Strides s;
  memcpy(&s, strides, sizeof(s));
  const Args a{static_cast<const float*>(q), static_cast<const float*>(dout), s.qb, s.qh, s.qn, s.ob, s.oh, s.on,
               static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dq),
               static_cast<float*>(dq), s.xb, s.xh, s.xn, s.xb, s.xh, s.xn, H, N, M, D, scale, 1.f};
  const long long sk[3] = {s.kb, s.kh, s.kn}, sv[3] = {s.vb, s.vh, s.vn};
  return launch_d<false>(k, sk, v, sv, a, B, reinterpret_cast<cudaStream_t>(stream));
}
