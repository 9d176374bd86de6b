// K7-K10: the diagnostic flash-attention kernels of the attention bench tool,
// bf16 only. They replace the Pallas TPU kernels of tools/bench_attn_diag.py:
//   K7  the kernel of `make_kernel` (:20), launched by `run` (:64), five
//       variants of one kv loop: full, exp2, no_max, no_exp, matmul_only;
//   K8  the inner kernel of `run_fori_exp2` (:112);
//   K9  the inner kernel of `run_grid3` (:164);
//   K10 the inner kernel of `run_grid3b` (:259).
// The tool exists to find out what bounds a flash kernel on the device; each
// kernel here is the same mma.sync / ex2 loop as K1 (csrc/flash_attention.cu)
// with one kind of work taken out or changed, so that its time against K1's
// says what that work costs on an H100:
//   K7 full        s = QK^T * scale in fp32, p = exp(s - m) (an FMUL by the
//                  scale, then ex2.approx of (s - m) * log2(e), one FFMA),
//                  running max, alpha = exp(m - m_new) or 0 while m is -inf,
//                  rescale of l and acc;
//   K7 exp2        the same with alpha = 1: no rescale. The max is committed
//                  once per `block_k` kv rows, so the result depends on
//                  block_k (exact softmax only at block_k = N). block_k = 64
//                  is one tile; a larger multiple of 64 first sweeps the
//                  block's K tiles for its row max (as K6 does over a whole
//                  row), then computes with that max;
//   K7 no_max      p = exp(s * scale), no max, no rescale;
//   K7 no_exp      p = s * scale, no ex2 (l = the sum of the scaled logits);
//   K7 matmul_only p = QK^T rounded to bf16, no scale, no l, no max: the two
//                  products and the loads alone;
//   K8             K1's function with the tool's arithmetic: q pre-scaled by
//                  log2(e)/sqrt(d) and rounded to bf16 as its fragments are
//                  loaded, p = exp2(s - m), m starts at -1e30, out = acc / l;
//   K9             K8 with the kv tiles in a 3-stage cp.async ring;
//   K10            K9 with l from a ones column of V: the PV product gets one
//                  more n-tile whose mma.sync B fragment is a per-lane
//                  constant (K6's, csrc/flash_attention_one.cu), so there is
//                  no ones column in memory and no per-logit row-sum add, and
//                  l is the fp32 sum of the bf16-rounded P.
// Every K7 variant returns acc / max(l, 1e-20) (matmul_only: acc * 1e20).
//
// The TPU tool holds the whole kv axis of a head in VMEM for K7 and K8 (one
// grid step runs the kv loop) and lets Mosaic pipeline the kv axis for K9
// and K10. The H100 form of the first is a loop whose tiles are loaded
// synchronously (cp.async, wait, barrier, compute; no prefetch): K7 and K8.
// The form of the second keeps STAGES - 1 tiles in flight while one is
// computed: K9 and K10. So K8 against K9 is what the overlap buys.
//
// What bounds them: at [2, 8, 4096, 16] the exp variants do 268 M exp2 on
// the SFU (16 per SM per clock, ~64 us), against 17.2 GFLOP of mma.sync
// (~17 us at the bf16 peak) and 8.4 MB of q/k/v/o (~3 us); no_exp and
// matmul_only have no exp2 and are bounded by the products.
//
// Layout: contiguous [B*H, N, D] bf16 q, k, v (k and v as long as q), out the
// same; N a multiple of 64; D a multiple of 8 up to 128, zero-padded to
// 16/32/64/128 in shared memory only. One CTA of 4 warps per (b*h, 64-row q
// tile); each warp owns 16 q rows as m16n8k16 A fragments. K tiles are read
// as 32-bit B fragments, V tiles by ldmatrix.trans, both from row-major
// shared memory with a padded row stride (no bank conflicts), as in K1.

#include <math.h>

#include "flash_common.cuh"

namespace {

constexpr int BM = 64;  // q rows per CTA (16 per warp)
constexpr int BN = 64;  // kv rows per shared-memory tile
constexpr float LOG2E = 1.4426950408889634f;

enum Variant { V_FULL = 0, V_EXP2 = 1, V_NO_MAX = 2, V_NO_EXP = 3, V_MATMUL_ONLY = 4, V_FLASH = 5, V_ONES = 6 };

template <int DP, int VAR, int STAGES>
__global__ void __launch_bounds__(128) diag_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int N, int D, float scale,
    int block_k) {
  constexpr int KS = DP + 8;   // tile row stride (elements): 16-byte rows, no bank conflicts
  constexpr int CPR = DP / 8;  // 16-byte chunks per tile row
  constexpr int NT = DP / 8;   // n-tiles of V; K10's ones tile is n-tile NT
  constexpr bool K7 = VAR <= V_MATMUL_ONLY;
  constexpr bool PRESCALED = !K7;  // K8-K10: q * log2(e)/sqrt(d), rounded to bf16
  constexpr bool RESCALE = VAR == V_FULL || VAR == V_FLASH || VAR == V_ONES;  // exp2 keeps alpha = 1
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Ks = smem;                     // [STAGES][BN][KS]
  uint16_t* Vs = smem + STAGES * BN * KS;  // [STAGES][BN][KS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const long long head = (long long)blockIdx.y * N * D;
  const __nv_bfloat16* qp = q + head;
  const uint16_t* kp = reinterpret_cast<const uint16_t*>(k + head);
  const uint16_t* vp = reinterpret_cast<const uint16_t*>(v + head);
  __nv_bfloat16* op = o + head;
  const int r0 = blockIdx.x * BM + warp * 16;
  const int ntiles = N / BN;

  // one 16-byte cp.async per (row, chunk) of K (and V) tile t into buffer
  // buf; columns past D are zero. Commits one group.
  auto load_tile = [&](int t, int buf, bool with_v) {
    const int kv0 = t * BN;
    for (int i = tid; i < BN * CPR; i += 128) {
      const int r = i / CPR, c = (i % CPR) * 8;
      uint16_t* dk = Ks + buf * BN * KS + r * KS + c;
      uint16_t* dv = Vs + buf * BN * KS + r * KS + c;
      if (c < D) {
        cp_async16(dk, kp + (long long)(kv0 + r) * D + c);
        if (with_v) cp_async16(dv, vp + (long long)(kv0 + r) * D + c);
      } else {
        *reinterpret_cast<uint4*>(dk) = make_uint4(0, 0, 0, 0);
        if (with_v) *reinterpret_cast<uint4*>(dv) = make_uint4(0, 0, 0, 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // the synchronous form: every warp is done with the buffer, load, wait, barrier
  auto load_now = [&](int t, bool with_v) {
    __syncthreads();
    load_tile(t, 0, with_v);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  };

  if constexpr (STAGES > 1) {
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < ntiles) load_tile(st, st, true);
      else asm volatile("cp.async.commit_group;\n" ::);  // an empty group keeps the count
    }
  }

  // Q as A fragments: a0 (g, 2tg), a1 (g+8, 2tg), a2 (g, 2tg+8), a3 (g+8, 2tg+8)
  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + g + (i & 1) * 8;
      const int col = kk * 16 + tg * 2 + (i >> 1) * 8;
      uint32_t w = col < D ? *reinterpret_cast<const uint32_t*>(qp + (long long)row * D + col) : 0u;
      if (PRESCALED) {  // (q.float() * scale).to(bf16), round to nearest even
        const float lo = __uint_as_float(w << 16), hi = __uint_as_float(w & 0xFFFF0000u);
        w = pack_f32(lo * scale, hi * scale);
      }
      qa[kk][i] = w;
    }
  }

  // raw S = Q K^T of this warp's 16 rows x 64 kv columns (8 n-tiles of 8);
  // c0,c1 belong to row g, c2,c3 to row g+8
  auto logits = [&](const uint16_t* Kt, float (&sc)[BN / 8][4]) {
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
      const uint16_t* kr = Kt + (nt * 8 + g) * KS + tg * 2;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma_bf16(sc[nt], qa[kk], b0, b1);
      }
    }
  };
  auto row_max = [&](const float (&sc)[BN / 8][4], float (&mx)[2]) {
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], sc[nt][i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
  };

  constexpr int NACC = VAR == V_ONES ? NT + 1 : NT;
  float acc[NACC][4];
#pragma unroll
  for (int dt = 0; dt < NACC; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  float m_run[2];
  m_run[0] = m_run[1] = K7 ? -INFINITY : -1e30f;
  float l_run[2] = {0.f, 0.f};
  float m_blk[2] = {-INFINITY, -INFINITY};  // exp2 at block_k > 64: the block's committed max
  // B fragment of the ones tile (K10): B[k][n] = 1 for n == 0, else 0; a lane
  // holds B[2tg .. 2tg+1][g] and B[2tg+8 .. 2tg+9][g], so the lanes with g == 0 hold two bf16 ones twice
  const uint32_t ones = (g == 0) ? 0x3F803F80u : 0u;

  for (int t = 0; t < ntiles; ++t) {
    if (VAR == V_EXP2 && block_k > BN && (t * BN) % block_k == 0) {
      // a new block: sweep its K tiles for the row max of the raw logits
      // (the scale is positive, so max(s * scale) = max(s) * scale exactly)
      float bm[2] = {-INFINITY, -INFINITY};
      for (int u = t; u < t + block_k / BN; ++u) {
        load_now(u, false);
        float sc[BN / 8][4];
        logits(Ks, sc);
        row_max(sc, bm);
      }
      m_blk[0] = fmaxf(m_run[0], bm[0] * scale);
      m_blk[1] = fmaxf(m_run[1], bm[1] * scale);
    }
    int buf = 0;
    if constexpr (STAGES == 1) {
      load_now(t, true);
    } else {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
      __syncthreads();  // tile t is visible; every warp is done with tile t-1's buffer
      const int nxt = t + STAGES - 1;  // streams in while tile t is computed
      if (nxt < ntiles) load_tile(nxt, nxt % STAGES, true);
      else asm volatile("cp.async.commit_group;\n" ::);
      buf = t % STAGES;
    }
    const uint16_t* Kt = Ks + buf * BN * KS;
    const uint16_t* Vt = Vs + buf * BN * KS;

    float sc[BN / 8][4];
    logits(Kt, sc);

    // P for this tile into bf16 A fragments for P V (k = kv); rs: this
    // thread's part of the row sums; alpha: the rescale of l and acc
    uint32_t pa[BN / 16][4];
    float rs[2] = {0.f, 0.f};
    float alpha[2] = {1.f, 1.f};
    float mx[2] = {m_run[0], m_run[1]};
    if (VAR == V_FULL || VAR == V_EXP2 || VAR == V_NO_MAX || VAR == V_NO_EXP) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[nt][i] *= scale;
    }
    if (VAR == V_FULL || VAR == V_FLASH || VAR == V_ONES || (VAR == V_EXP2 && block_k == BN)) row_max(sc, mx);
    if (VAR == V_EXP2 && block_k > BN) {
      mx[0] = m_blk[0];
      mx[1] = m_blk[1];
    }
    if (RESCALE) {  // K7: exp(m - m_new), 0 while m is -inf; K8-K10: exp2(m - m_new)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        alpha[r] = !K7 ? ex2(m_run[r] - mx[r]) : isfinite(m_run[r]) ? ex2((m_run[r] - mx[r]) * LOG2E) : 0.f;
    }
    m_run[0] = mx[0];
    m_run[1] = mx[1];
    const float mxl[2] = {mx[0] * LOG2E, mx[1] * LOG2E};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float s = sc[nt][i];
        if (VAR == V_FULL || VAR == V_EXP2) p[i] = ex2(fmaf(s, LOG2E, -mxl[i >> 1]));
        else if (VAR == V_NO_MAX) p[i] = ex2(s * LOG2E);
        else if (VAR == V_FLASH || VAR == V_ONES) p[i] = ex2(s - mx[i >> 1]);
        else p[i] = s;  // no_exp: the scaled logit; matmul_only: the raw one
        if (VAR != V_MATMUL_ONLY && VAR != V_ONES) rs[i >> 1] += p[i];
      }
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_f32(p[0], p[1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_f32(p[2], p[3]);
    }
    l_run[0] = l_run[0] * alpha[0] + rs[0];
    l_run[1] = l_run[1] * alpha[1] + rs[1];
    if (RESCALE) {
#pragma unroll
      for (int dt = 0; dt < NACC; ++dt) {
        acc[dt][0] *= alpha[0];
        acc[dt][1] *= alpha[0];
        acc[dt][2] *= alpha[1];
        acc[dt][3] *= alpha[1];
      }
    }
    // V fragments by ldmatrix.trans: lane l addresses row (l & 15) of the
    // 16-row kv block, at column d0 + 8 * (l >> 4)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
#pragma unroll
      for (int dt = 0; dt < NT; dt += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vt + (j * 16 + (lane & 15)) * KS + (dt + (lane >> 4)) * 8);
        mma_bf16(acc[dt], pa[j], bv[0], bv[1]);
        mma_bf16(acc[dt + 1], pa[j], bv[2], bv[3]);
      }
      if (VAR == V_ONES) mma_bf16(acc[NACC - 1], pa[j], ones, ones);  // acc[NT] column 0 += rowsum(P)
    }
  }

  float den[2];
  if (VAR == V_ONES) {  // l is column 0 of the ones tile: c0 (row g) and c2 (row g+8) of the lanes with tg == 0
    den[0] = __shfl_sync(0xffffffffu, acc[NACC - 1][0], lane & ~3);
    den[1] = __shfl_sync(0xffffffffu, acc[NACC - 1][2], lane & ~3);
  } else {  // each thread summed only its own columns: finish the row sums in the quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      den[r] = l_run[r] + __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      den[r] += __shfl_xor_sync(0xffffffffu, den[r], 2);
    }
  }
  if (K7) {  // K7 returns acc / max(l, 1e-20)
#pragma unroll
    for (int r = 0; r < 2; ++r) den[r] = fmaxf(den[r], 1e-20f);
  }
#pragma unroll
  for (int dt = 0; dt < NT; ++dt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + r * 8;
      const int col = dt * 8 + tg * 2;
      if (col < D)
        *reinterpret_cast<uint32_t*>(op + (long long)row * D + col) =
            pack_f32(acc[dt][2 * r] / den[r], acc[dt][2 * r + 1] / den[r]);
    }
}

template <int DP, int VAR, int STAGES>
int launch(int BH, int N, int D, float scale, int block_k, const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, __nv_bfloat16* o, cudaStream_t st) {
  const int smem = 2 * STAGES * BN * (DP + 8) * (int)sizeof(uint16_t);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(diag_bf16<DP, VAR, STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  diag_bf16<DP, VAR, STAGES><<<dim3(N / BM, BH), 128, smem, st>>>(q, k, v, o, N, D, scale, block_k);
  return (int)cudaGetLastError();
}

template <int VAR, int STAGES>
int launch_d(int BH, int N, int D, float scale, int block_k, const __nv_bfloat16* q, const __nv_bfloat16* k,
             const __nv_bfloat16* v, __nv_bfloat16* o, cudaStream_t st) {
  if (D <= 16) return launch<16, VAR, STAGES>(BH, N, D, scale, block_k, q, k, v, o, st);
  if (D <= 32) return launch<32, VAR, STAGES>(BH, N, D, scale, block_k, q, k, v, o, st);
  if (D <= 64) return launch<64, VAR, STAGES>(BH, N, D, scale, block_k, q, k, v, o, st);
  return launch<128, VAR, STAGES>(BH, N, D, scale, block_k, q, k, v, o, st);
}

}  // namespace

// kind: 0-4 the K7 variants full, exp2, no_max, no_exp, matmul_only; 5 K8;
// 6 K9; 7 K10. q, k, v, o: contiguous bf16 [BH, N, D], N % 64 == 0,
// D % 8 == 0, D <= 128 (K10: D < 128). scale: 1/sqrt(d) for K7,
// log2(e)/sqrt(d) for K8-K10. block_k: K7 exp2's max granularity, a
// multiple of 64 dividing N (ignored by the others). Returns
// cudaGetLastError() after the launch.
extern "C" int attn_diag(int kind, const void* q, const void* k, const void* v, void* o, int BH, int N, int D,
                         float scale, int block_k, void* stream) {
  if (N < BN || N % BN || D < 8 || D % 8 || D > 128 || BH < 1) return (int)cudaErrorInvalidValue;
  if (kind == V_EXP2 && (block_k < BN || block_k % BN || N % block_k)) return (int)cudaErrorInvalidValue;
  if (kind == 7 && D == 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto* qq = static_cast<const __nv_bfloat16*>(q);
  auto* kk = static_cast<const __nv_bfloat16*>(k);
  auto* vv = static_cast<const __nv_bfloat16*>(v);
  auto* oo = static_cast<__nv_bfloat16*>(o);
  switch (kind) {
    case 0: return launch_d<V_FULL, 1>(BH, N, D, scale, block_k, qq, kk, vv, oo, st);
    case 1: return launch_d<V_EXP2, 1>(BH, N, D, scale, block_k, qq, kk, vv, oo, st);
    case 2: return launch_d<V_NO_MAX, 1>(BH, N, D, scale, block_k, qq, kk, vv, oo, st);
    case 3: return launch_d<V_NO_EXP, 1>(BH, N, D, scale, block_k, qq, kk, vv, oo, st);
    case 4: return launch_d<V_MATMUL_ONLY, 1>(BH, N, D, scale, block_k, qq, kk, vv, oo, st);
    case 5: return launch_d<V_FLASH, 1>(BH, N, D, scale, block_k, qq, kk, vv, oo, st);
    case 6: return launch_d<V_FLASH, 3>(BH, N, D, scale, block_k, qq, kk, vv, oo, st);
    case 7: return launch_d<V_ONES, 3>(BH, N, D, scale, block_k, qq, kk, vv, oo, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
