// K2: one fused HiFi-GAN multi-receptive-field (MRF) stage, fp32 accuracy,
// on Hopper's tensor cores (wgmma, tf32) with a 3xTF32 split.
//
// Replaces the Pallas TPU kernel `_mrf_kernel`
// (audioldm_tpu/kernels/mrf_conv.py:120, launched by `_fused_mrf_stage_impl`).
//
//   out = mean_j resblock_j(x),  resblock_j: for each dilation d of block j:
//         x = x + conv_{k,1}(leaky(conv_{k,d}(leaky(x))))
//
// over channel-major x [B, C, T] (C <= 64), every conv output masked to the
// signal [0, T) (the zero-padded conv chain of the plain version). With
// `post_k > 0` the epilogue also applies leaky(0.01), conv_post (post_k taps,
// C -> 1 channel) and tanh, and writes the waveform [B, 1, T].
//
// What bounds it on an H100: the audioldm-s stages run 126 tap-convolutions
// of 2*C^2*T FLOP each (84.6 GFLOP at C=64, T=81936; 42.3 GFLOP at C=32,
// T=163872) while only the stage input and output cross device memory (~42
// MB a stage). At fp32 accuracy that is three TF32 products a term on the
// tensor cores (495 TFLOP/s: 0.513 and 0.256 ms), against 1.262 and 0.632 ms
// of fp32 FMA. The design:
//   - 3xTF32: every product is a_hi b_hi + a_lo b_hi + a_hi b_lo,
//     accumulated in fp32, the lo*lo term (~2^-20 relative) dropped. The
//     weights are split by the wrapper (hi = tf32 round to nearest, lo =
//     the same of the rest); an activation x by one LOP and one FADD: hi =
//     x truncated to tf32, lo = x - hi, of which the tensor core reads the
//     tf32 part (two cvt.rna an element cost more issue slots than the
//     products at C = 32);
//   - each conv is an implicit GEMM a tap at a time: rows = 64 output
//     positions (a wgmma tile), columns = the CP output channels, K = input
//     channels 8 at a time (m64nCPk8 tf32). A is the activation buffer read
//     by each thread straight into the register fragment at the row shift
//     tap*dil - pad (a shared-memory A operand cannot take an arbitrary row
//     shift: its core matrices are 8 rows), leaky-ReLU'd and split on the
//     way, in two register sets of KG k steps that take turns; B is the
//     tap's weights, packed by the wrapper in the no-swizzle K-major
//     core-matrix layout ([co/8][ci/4][8][4] floats) as a hi plane and a lo
//     plane;
//   - only the rows a conv still needs are computed: conv c keeps the
//     positions within its margin m_c of the output tile (the margin shrinks
//     conv by conv, 58 -> 3 for k = 11), ceil((TT + 2 m_c) / 64) tiles, the
//     last shifted back to end on the range (its overlap is not written
//     twice). Two consumer warpgroups split the tiles and each keeps the
//     accumulators of all its tiles in registers while the taps stream
//     past, so each weight plane is read once a tile; the tile count of a
//     warpgroup is a template parameter (conv_nt), because ptxas serializes
//     the wgmma pipeline of a product under a run-time condition;
//   - the weight planes stream through a ring of NST shared-memory stages,
//     fed by one thread of a producer warpgroup with cp.async.bulk (no
//     tensor map: each plane is one contiguous block, in the order the
//     consumers take them) and full/empty mbarriers; the consumers release
//     a tap's two planes when its products are done. The producer
//     warpgroup gives its registers to the consumers (setmaxnreg), but
//     ptxas compiles every thread for 168 (65,536 over 384 threads): so a
//     warpgroup takes at most two 64 x 64 tiles at CP = 64 (TT <= 128;
//     three spill their accumulators and run slower: PERF.md, variant
//     `tt192_at_64` of audioldm_tpu_torch/tools/mrf_variants.py);
//   - the residual stream v and the intermediate h are fp32 [CP][LS]
//     buffers over the CTA's TT positions plus the chain's halo H on each
//     side (LS = TT + 2H rounded up to 8 or 24 mod 32, so that the eight
//     rows and four channels of an A fragment load fall in 32 banks),
//     filled from x by 4-byte cp.async; the sum over resblocks goes to y
//     itself (read-modify-write of the CTA's own positions) or, with
//     conv_post, to a [CP][TT + 2 pm] shared buffer.
// The host picks TT (<= 128 at CP = 64, <= 384 below) as the one with the
// least estimated time (waves of CTAs over the SMs times the row tiles a
// CTA computes) among those that leave at least 4 ring stages in the
// 232,448 bytes of shared memory a CTA may have: at [1, 64, 81936] v and h
// are 2*64*LS*4 bytes and a stage 16,384; with conv_post at C = 32, v, h
// and the sum 2*32*LS*4 + 32*(TT + 6)*4 and a stage 4,096
// (`mrf_stage_plan` reports the choice).
// Grid: ceil(T / TT) x B; 384 threads, one CTA an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int MAXR = 3, MAXU = 3;  // resblocks per stage, units per resblock
constexpr int NCONSUMER = 256;  // two consumer warpgroups
constexpr int NTHREADS = NCONSUMER + 128;  // and a producer warpgroup (one thread of it works)
// registers a thread after setmaxnreg: 128 x 40 + 256 x 232 = 64,512 of 65,536
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_STAGES = 8;

struct Cfg {
  int nres, nunit, C, T, post_k, TT, H, LS, nst;
  int ks[MAXR];
  int dil[MAXR][MAXU];
  float slope;
};

// rows of output tiles a CTA computes at most: ceil((TT_max + 2 * 63) / 64)
template <int CP>
struct Tiles {
  static constexpr int TTMAX = CP == 64 ? 128 : 384;
  static constexpr int MAXT = (TTMAX + 126 + 63) / 64;
  static constexpr int MAXW = (MAXT + 1) / 2;  // of a warpgroup
};

// leaky ReLU for a slope in [0, 1] (the wrapper checks it)
__device__ __forceinline__ float leaky(float x, float s) { return fmaxf(x, x * s); }

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// 4 bytes global -> shared, asynchronously; zero-filled when !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// Shared-memory layout: the weight ring first (plane-aligned), then v, h,
// the resblock sum (with conv_post) and the barriers.
template <int CP>
struct Smem {
  static constexpr int PLANE = CP * CP * 4;  // bytes of one weight plane (hi or lo of one tap)
  static __host__ __device__ int v_off(int nst) { return nst * PLANE; }
  static __host__ __device__ int h_off(int nst, int LS) { return v_off(nst) + CP * LS * 4; }
  static __host__ __device__ int acc_off(int nst, int LS) { return h_off(nst, LS) + CP * LS * 4; }
  static __host__ __device__ int bar_off(int nst, int LS, int aw) { return acc_off(nst, LS) + CP * aw * 4; }
  static __host__ __device__ int total(int nst, int LS, int aw) { return bar_off(nst, LS, aw) + 16 * nst; }
};

// Per-thread state of the consumers that the conv loop needs.
struct Consumer {
  int wg, warp, g, t;  // warpgroup, warp within it, fragment row and column
  uint32_t ring, full0, empty0;
  int nst;
  int it;  // planes consumed so far
};

// The tap's two weight planes are in shared memory: their ring stages
__device__ __forceinline__ void wait_tap(const Consumer& c, int& st_hi, int& st_lo) {
  st_hi = c.it % c.nst;
  st_lo = (c.it + 1) % c.nst;
  mbar_wait(c.full0 + 8 * st_hi, (c.it / c.nst) & 1);
  mbar_wait(c.full0 + 8 * st_lo, ((c.it + 1) / c.nst) & 1);
}

// This warp is done with the tap's planes (its warpgroup's products are)
__device__ __forceinline__ void release_tap(Consumer& c, int st_hi, int st_lo) {
  if (c.t == 0 && c.g == 0) {  // lane 0 of every consumer warp
    mbar_arrive(c.empty0 + 8 * st_hi);
    mbar_arrive(c.empty0 + 8 * st_lo);
  }
  c.it += 2;
}

// One conv of the chain over the rows [lo, hi) of the buffers: NT row
// tiles of this warpgroup, the first one tile i0 of the conv's tiles, every
// output channel. CONV1: dst = leaky(mask(conv(leaky(src))));
// else dst += mask(conv(src)). `bias` is this conv's [CP] bias; it
// consumes 2 k planes (hi, lo a tap).
template <int CP, bool CONV1, int NT>
__device__ __forceinline__ void conv_tiles(const float* __restrict__ src, float* __restrict__ dst,
                                           const float* __restrict__ bias, int k, int dil, int lo, int hi, int i0,
                                           const Cfg& cfg, int t0, Consumer& c) {
  constexpr int KC = CP / 8;           // k steps of 8 input channels
  constexpr int KG = KC < 2 ? KC : 2;  // k steps a register set of A fragments holds
  constexpr int SBO = (CP / 4) * 128;  // bytes from one 8-channel group of co to the next
  const int LS = cfg.LS;
  const int pad = (k - 1) * dil / 2;
  if (NT == 0) {  // no tile for this warpgroup: only take part in the ring
    for (int tap = 0; tap < k; ++tap) {
      int st_hi, st_lo;
      wait_tap(c, st_hi, st_lo);
      release_tap(c, st_hi, st_lo);
    }
    return;
  }
  float acc[NT > 0 ? NT : 1][CP / 2];
  uint32_t ah[2][KG][4], al[2][KG][4];  // two register sets of KG k steps, taking turns
  const float* sp[NT > 0 ? NT : 1];
#pragma unroll
  for (int i = 0; i < NT; ++i) sp[i] = src + min(lo + 64 * (i0 + i), hi - 64) + 16 * c.warp + c.g;

  for (int tap = 0; tap < k; ++tap) {
    int st_hi, st_lo;
    wait_tap(c, st_hi, st_lo);
    const uint32_t bhi = c.ring + st_hi * Smem<CP>::PLANE;
    const uint32_t blo = c.ring + st_lo * Smem<CP>::PLANE;
    const int off = tap * dil - pad;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int gq = 0; gq < KC / KG; ++gq) {
        const int set = (i * (KC / KG) + gq) & 1;
        wg_wait<1>();  // the products that read this register set are done
#pragma unroll
        for (int kk = 0; kk < KG; ++kk) {
          const float* p0 = sp[i] + off + ((gq * KG + kk) * 8 + c.t) * LS;
          const float* p1 = p0 + 4 * LS;
          float x[4] = {p0[0], p0[8], p1[0], p1[8]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (CONV1) x[e] = leaky(x[e], cfg.slope);
            split(x[e], ah[set][kk][e], al[set][kk][e]);
          }
        }
        fence_regs(ah[set]);  // (the accumulators are not pinned here: a product on them may be in flight)
        fence_regs(al[set]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KG; ++kk) {
          const int kc = gq * KG + kk;
          const uint64_t dh = desc(bhi + kc * 256, 128, SBO, 0);
          const uint64_t dl = desc(blo + kc * 256, 128, SBO, 0);
          WgmmaTF32<CP>::run(acc[i], ah[set][kk], dh, tap > 0 || kc > 0);  // the conv's first product overwrites
          WgmmaTF32<CP>::run(acc[i], al[set][kk], dh, 1);
          WgmmaTF32<CP>::run(acc[i], ah[set][kk], dl, 1);
        }
        wg_commit();
      }
    }
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < NT; ++i) fence_regs(acc[i]);
    release_tap(c, st_hi, st_lo);
  }

  // epilogue: bias, the signal mask, leaky (CONV1) or the residual add; tile
  // i0 + i writes the rows [lo + 64 (i0 + i), min(lo + 64 (i0 + i + 1), hi))
  // of the rows [s0, s0 + 64) it computed
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int s0 = min(lo + 64 * (i0 + i), hi - 64);
    const int w0 = lo + 64 * (i0 + i), w1 = min(w0 + 64, hi);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = s0 + 16 * c.warp + c.g + 8 * r;
      if (row < w0 || row >= w1) continue;
      const int p = t0 - cfg.H + row;
      const bool sig = p >= 0 && p < cfg.T;
#pragma unroll
      for (int j = 0; j < CP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = 8 * j + 2 * c.t + e;
          const float val = sig ? acc[i][4 * j + 2 * r + e] + bias[co] : 0.f;
          float* d = dst + co * LS + row;
          if (CONV1) *d = leaky(val, cfg.slope);
          else *d += val;
        }
    }
  }
}

// conv_tiles for a tile count known at run time, nt <= MAXNT: each count
// its own instance (a product under a run-time condition makes ptxas
// serialize the wgmma pipeline)
template <int CP, bool CONV1, int MAXNT, int NT = 0>
__device__ __forceinline__ void conv_nt(int nt, const float* __restrict__ src, float* __restrict__ dst,
                                        const float* __restrict__ bias, int k, int dil, int lo, int hi, int i0,
                                        const Cfg& cfg, int t0, Consumer& c) {
  if constexpr (NT < MAXNT) {
    if (nt != NT) {
      conv_nt<CP, CONV1, MAXNT, NT + 1>(nt, src, dst, bias, k, dil, lo, hi, i0, cfg, t0, c);
      return;
    }
  }
  conv_tiles<CP, CONV1, NT>(src, dst, bias, k, dil, lo, hi, i0, cfg, t0, c);
}

// One conv over the rows [lo, hi), in ceil((hi - lo) / 64) row tiles: the
// first half (rounded up) to warpgroup 0, the rest to warpgroup 1, each
// computing every output channel (no A fragment is loaded twice)
template <int CP, bool CONV1>
__device__ __forceinline__ void conv(const float* __restrict__ src, float* __restrict__ dst,
                                     const float* __restrict__ bias, int k, int dil, int lo, int hi, const Cfg& cfg,
                                     int t0, Consumer& c) {
  const int ntile = (hi - lo + 63) / 64;
  const int half = (ntile + 1) / 2;
  const int i0 = c.wg ? half : 0, nt = c.wg ? ntile - half : half;
  conv_nt<CP, CONV1, Tiles<CP>::MAXW>(nt, src, dst, bias, k, dil, lo, hi, i0, cfg, t0, c);
}

template <int CP>
__global__ void __launch_bounds__(NTHREADS, 1) mrf_stage_kernel(
    const float* __restrict__ x, float* __restrict__ y, const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ wp, const float* __restrict__ bp, Cfg cfg) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int LS = cfg.LS, TT = cfg.TT, H = cfg.H;
  const int pm = cfg.post_k > 0 ? (cfg.post_k - 1) / 2 : 0;
  const int aw = cfg.post_k > 0 ? TT + 2 * pm : 0;
  float* v = reinterpret_cast<float*>(smem + Smem<CP>::v_off(cfg.nst));    // [CP][LS] residual stream
  float* h = reinterpret_cast<float*>(smem + Smem<CP>::h_off(cfg.nst, LS));  // [CP][LS] intermediate
  float* accs = reinterpret_cast<float*>(smem + Smem<CP>::acc_off(cfg.nst, LS));  // [CP][aw] sum over resblocks
  const uint32_t ring = smem_u32(smem);
  const uint32_t full0 = smem_u32(smem + Smem<CP>::bar_off(cfg.nst, LS, aw)), empty0 = full0 + 8 * cfg.nst;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int nplanes = 0;
  for (int r = 0; r < cfg.nres; ++r) nplanes += 4 * cfg.nunit * cfg.ks[r];

  if (tid == 0) {
    for (int s = 0; s < cfg.nst; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NCONSUMER / 32);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NCONSUMER / 32) {  // producer: every plane of the stage, in the order the taps take them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == NCONSUMER / 32 && lane == 0) {
      const uint8_t* wb = reinterpret_cast<const uint8_t*>(w);
      for (int it = 0; it < nplanes; ++it) {
        const int s = it % cfg.nst;
        if (it >= cfg.nst) mbar_wait(empty0 + 8 * s, ((it / cfg.nst) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, Smem<CP>::PLANE);
        bulk_load(ring + s * Smem<CP>::PLANE, wb + (long long)it * Smem<CP>::PLANE, Smem<CP>::PLANE, full0 + 8 * s);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  Consumer c;
  c.wg = warp >> 2;
  c.warp = warp & 3;
  c.g = lane >> 2;
  c.t = lane & 3;
  c.ring = ring;
  c.full0 = full0;
  c.empty0 = empty0;
  c.nst = cfg.nst;
  c.it = 0;
  const float* xb = x + (long long)b * cfg.C * cfg.T;
  const int L = TT + 2 * H;
  for (int i = tid; i < CP * aw; i += NCONSUMER) accs[i] = 0.f;

  const float* bias_r = bias;
  for (int r = 0; r < cfg.nres; ++r) {
    const int k = cfg.ks[r];
    // margins, from the last conv (which must cover the post taps) backwards
    int m1[MAXU], m2[MAXU];
    int m = pm;
    for (int u = cfg.nunit - 1; u >= 0; --u) {
      m2[u] = m;
      m += (k - 1) / 2;
      m1[u] = m;
      m += (k - 1) * cfg.dil[r][u] / 2;
    }
    consumers_sync();  // the previous resblock's v is consumed
    for (int i = tid; i < CP * L; i += NCONSUMER) {  // x's window, zero outside the signal and past C
      const int ch = i / L, pos = i % L, p = t0 - H + pos;
      const bool ok = ch < cfg.C && p >= 0 && p < cfg.T;
      cp_async4(v + ch * LS + pos, ok ? xb + (long long)ch * cfg.T + p : xb, ok);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    consumers_sync();
    for (int u = 0; u < cfg.nunit; ++u) {
      const int d = cfg.dil[r][u];
      conv<CP, true>(v, h, bias_r, k, d, H - m1[u], H + TT + m1[u], cfg, t0, c);
      consumers_sync();
      conv<CP, false>(h, v, bias_r + CP, k, 1, H - m2[u], H + TT + m2[u], cfg, t0, c);
      consumers_sync();
      bias_r += 2 * CP;
    }
    if (cfg.post_k > 0) {
      for (int i = tid; i < CP * aw; i += NCONSUMER) {
        const int ch = i / aw, j = i % aw;
        accs[i] += v[ch * LS + H - pm + j];
      }
    } else {  // the sum goes to y: each thread reads back only what it wrote
      float* yb = y + (long long)b * cfg.C * cfg.T;
#pragma unroll 4
      for (int i = tid; i < cfg.C * TT; i += NCONSUMER) {
        const int ch = i / TT, j = i % TT, p = t0 + j;
        if (p >= cfg.T) continue;
        const float val = v[ch * LS + H + j];
        float* yp = yb + (long long)ch * cfg.T + p;
        if (r == 0) *yp = cfg.nres == 1 ? val / cfg.nres : val;
        else if (r + 1 < cfg.nres) *yp += val;
        else *yp = (*yp + val) / cfg.nres;
      }
    }
  }
  if (cfg.post_k == 0) return;
  consumers_sync();
  for (int j = tid; j < TT; j += NCONSUMER) {
    const int p = t0 + j;
    if (p >= cfg.T) continue;
    float s = bp[0];
    for (int ch = 0; ch < cfg.C; ++ch) {
      const float* ar = accs + ch * aw + j;
      for (int tap = 0; tap < cfg.post_k; ++tap)
        s = fmaf(wp[ch * cfg.post_k + tap], leaky(ar[tap] / cfg.nres, 0.01f), s);
    }
    y[(long long)b * cfg.T + p] = tanhf(s);
  }
}

// the row tiles one CTA computes over the whole stage, each weighted by its taps
int tile_taps(const Cfg& cfg, int TT) {
  const int pm = cfg.post_k > 0 ? (cfg.post_k - 1) / 2 : 0;
  int total = 0;
  for (int r = 0; r < cfg.nres; ++r) {
    const int k = cfg.ks[r];
    int m = pm;
    for (int u = cfg.nunit - 1; u >= 0; --u) {
      total += k * ((TT + 2 * m + 63) / 64);
      m += (k - 1) / 2;
      total += k * ((TT + 2 * m + 63) / 64);
      m += (k - 1) * cfg.dil[r][u] / 2;
    }
  }
  return total;
}

// TT, LS and the ring depth for this stage: the least estimated time (waves
// of CTAs over the SMs times the tiles a CTA computes) among the tile
// lengths that fit with at least 4 ring stages. Returns the dynamic shared
// memory in bytes, or 0 if nothing fits.
template <int CP>
int plan(Cfg& cfg, int B, int nsm) {
  const int pm = cfg.post_k > 0 ? (cfg.post_k - 1) / 2 : 0;
  long long best = -1;
  int best_smem = 0;
  for (int TT = 64; TT <= Tiles<CP>::TTMAX; TT += 8) {
    if ((TT + 2 * cfg.H + 63) / 64 > Tiles<CP>::MAXT) break;
    int LS = TT + 2 * cfg.H;
    while (LS % 32 != 8 && LS % 32 != 24) ++LS;
    const int aw = cfg.post_k > 0 ? TT + 2 * pm : 0;
    int nst = MAX_STAGES;
    while (nst >= 4 && Smem<CP>::total(nst, LS, aw) > SMEM_LIMIT) --nst;
    if (nst < 4) continue;
    const long long ctas = (long long)B * ((cfg.T + TT - 1) / TT);
    const long long cost = ((ctas + nsm - 1) / nsm) * tile_taps(cfg, TT);
    if (best < 0 || cost <= best) {
      best = cost;
      cfg.TT = TT;
      cfg.LS = LS;
      cfg.nst = nst;
      best_smem = Smem<CP>::total(nst, LS, aw);
    }
  }
  return best_smem;
}

template <int CP>
int launch(const float* x, float* y, const float* w, const float* bias, const float* wp, const float* bp, Cfg cfg,
           int B, int nsm, cudaStream_t st) {
  const int smem = plan<CP>(cfg, B, nsm);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(mrf_stage_kernel<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((cfg.T + cfg.TT - 1) / cfg.TT, B);
  mrf_stage_kernel<CP><<<grid, NTHREADS, smem, st>>>(x, y, w, bias, wp, bp, cfg);
  return (int)cudaGetLastError();
}

// The stage's configuration from the C interface's arguments; false for a
// geometry the kernel does not take.
bool configure(Cfg& cfg, int C, int CP, int T, int nres, int nunit, const int* ks, const int* dils, float slope,
               int post_k, int halo) {
  if (nres < 1 || nres > MAXR || nunit < 1 || nunit > MAXU || (CP != 16 && CP != 32 && CP != 64) || C > CP ||
      C < 1 || T < 1 || post_k < 0 || (post_k > 0 && post_k % 2 == 0) || halo < 0 || halo > 64 ||
      !(slope >= 0.f && slope <= 1.f))
    return false;
  cfg.nres = nres;
  cfg.nunit = nunit;
  cfg.C = C;
  cfg.T = T;
  cfg.post_k = post_k;
  cfg.slope = slope;
  cfg.H = halo;
  int need = 0;
  for (int r = 0; r < nres; ++r) {
    if (ks[r] != 3 && ks[r] != 7 && ks[r] != 11) return false;
    cfg.ks[r] = ks[r];
    int span = post_k > 0 ? (post_k - 1) / 2 : 0;
    for (int u = 0; u < nunit; ++u) {
      cfg.dil[r][u] = dils[r * nunit + u];
      if (cfg.dil[r][u] < 1) return false;
      span += (ks[r] - 1) * cfg.dil[r][u] / 2 + (ks[r] - 1) / 2;
    }
    need = span > need ? span : need;
  }
  return need <= halo;
}

int num_sms(int* nsm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(nsm, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

}  // namespace

// x [B, C, T] fp32; y [B, C, T] (post_k == 0) or [B, 1, T]. w: for each
// resblock r, unit u, conv1 then conv2, for each tap: the hi plane, then the
// lo plane of the tap's [CP][CP] (co, ci) weights, channels zero-padded to
// CP (16, 32 or 64), each plane in the K-major core-matrix order
// [co/8][ci/4][8][4]; bias [nres][nunit][2][CP]; wp [C][post_k]; bp [1].
// dils [nres * nunit]. halo: the samples of context an output needs on each
// side (the chain's receptive field plus the post pad, <= 64). Kernel sizes
// must be 3, 7 or 11, the slope in [0, 1]. Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for an unsupported geometry, without
// launching).
extern "C" int mrf_stage(const float* x, float* y, const float* w, const float* bias, const float* wp,
                         const float* bp, int B, int C, int CP, int T, int nres, int nunit, const int* ks,
                         const int* dils, float slope, int post_k, int halo, void* stream) {
  Cfg cfg;
  if (!configure(cfg, C, CP, T, nres, nunit, ks, dils, slope, post_k, halo)) return (int)cudaErrorInvalidValue;
  int nsm = 0;
  if (const int err = num_sms(&nsm)) return err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (CP == 16) return launch<16>(x, y, w, bias, wp, bp, cfg, B, nsm, st);
  if (CP == 32) return launch<32>(x, y, w, bias, wp, bp, cfg, B, nsm, st);
  return launch<64>(x, y, w, bias, wp, bp, cfg, B, nsm, st);
}

// What mrf_stage would launch for these arguments, launching nothing:
// plan[0..3] = TT (samples a CTA writes), ring stages, dynamic shared memory
// in bytes, CTAs. Returns cudaErrorInvalidValue for an unsupported geometry.
extern "C" int mrf_stage_plan(int B, int C, int CP, int T, int nres, int nunit, const int* ks, const int* dils,
                              float slope, int post_k, int halo, int* plan_out) {
  Cfg cfg;
  if (!configure(cfg, C, CP, T, nres, nunit, ks, dils, slope, post_k, halo)) return (int)cudaErrorInvalidValue;
  int nsm = 0;
  if (const int err = num_sms(&nsm)) return err;
  const int smem = CP == 16 ? plan<16>(cfg, B, nsm) : CP == 32 ? plan<32>(cfg, B, nsm) : plan<64>(cfg, B, nsm);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  plan_out[0] = cfg.TT;
  plan_out[1] = cfg.nst;
  plan_out[2] = smem;
  plan_out[3] = B * ((T + cfg.TT - 1) / cfg.TT);
  return 0;
}
