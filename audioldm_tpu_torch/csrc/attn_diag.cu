// K8 and K10: the diagnostic flash-attention kernels of the attention bench
// tool that still run the previous K1 design's loop (K7 and K9 run K1's
// Hopper loop: attn_diag_sm90.cu), bf16 only. They replace the Pallas TPU
// kernels of tools/bench_attn_diag.py:
//   K8  the inner kernel of `run_fori_exp2` (:112);
//   K10 the inner kernel of `run_grid3b` (:259).
// The loop is the previous K1's (before the Hopper redesign): mma.sync
// products, 64-row q tiles, cp.async loads.
//   K8   K1's function with the tool's arithmetic: q pre-scaled by
//        log2(e)/sqrt(d) and rounded to bf16 as its fragments are loaded,
//        p = exp2(s - m), m starts at -1e30, out = acc / l; the kv tiles
//        are loaded synchronously (cp.async, wait, barrier, compute; no
//        prefetch), as the TPU tool holds the whole kv axis of a head in
//        VMEM for one grid step;
//   K10  K8 with the kv tiles in a 3-stage cp.async ring (the TPU tool lets
//        Mosaic pipeline the kv axis) and l from a ones column of V: the PV
//        product gets one more n-tile whose mma.sync B fragment is a
//        per-lane constant, so there is no ones column in memory and no
//        per-logit row-sum add, and l is the fp32 sum of the bf16-rounded P.
//
// What bounds them: at [2, 8, 4096, 16] 268 M exp2 on the SFU (16 per SM
// per clock, ~64 us), against 17.2 GFLOP of mma.sync (~17 us at the bf16
// peak) and 8.4 MB of q/k/v/o (~3 us).
//
// Layout: contiguous [B*H, N, D] bf16 q, k, v (k and v as long as q), out the
// same; N a multiple of 64; D a multiple of 8 up to 128, zero-padded to
// 16/32/64/128 in shared memory only. One CTA of 4 warps per (b*h, 64-row q
// tile); each warp owns 16 q rows as m16n8k16 A fragments. K tiles are read
// as 32-bit B fragments, V tiles by ldmatrix.trans, both from row-major
// shared memory with a padded row stride (no bank conflicts).

#include <math.h>

#include "flash_common.cuh"

namespace {

constexpr int BM = 64;  // q rows per CTA (16 per warp)
constexpr int BN = 64;  // kv rows per shared-memory tile

enum Variant { V_FLASH = 5, V_ONES = 7 };  // K8 (with STAGES 1), K10 (with STAGES 3)

template <int DP, int VAR, int STAGES>
__global__ void __launch_bounds__(128) diag_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int N, int D, float scale) {
  constexpr int KS = DP + 8;   // tile row stride (elements): 16-byte rows, no bank conflicts
  constexpr int CPR = DP / 8;  // 16-byte chunks per tile row
  constexpr int NT = DP / 8;   // n-tiles of V; K10's ones tile is n-tile NT
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

  // one 16-byte cp.async per (row, chunk) of K and V tile t into buffer
  // buf; columns past D are zero. Commits one group.
  auto load_tile = [&](int t, int buf) {
    const int kv0 = t * BN;
    for (int i = tid; i < BN * CPR; i += 128) {
      const int r = i / CPR, c = (i % CPR) * 8;
      uint16_t* dk = Ks + buf * BN * KS + r * KS + c;
      uint16_t* dv = Vs + buf * BN * KS + r * KS + c;
      if (c < D) {
        cp_async16(dk, kp + (long long)(kv0 + r) * D + c);
        cp_async16(dv, vp + (long long)(kv0 + r) * D + c);
      } else {
        *reinterpret_cast<uint4*>(dk) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dv) = make_uint4(0, 0, 0, 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // the synchronous form: every warp is done with the buffer, load, wait, barrier
  auto load_now = [&](int t) {
    __syncthreads();
    load_tile(t, 0);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  };

  if constexpr (STAGES > 1) {
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < ntiles) load_tile(st, st);
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
      const uint32_t w = col < D ? *reinterpret_cast<const uint32_t*>(qp + (long long)row * D + col) : 0u;
      // (q.float() * scale).to(bf16), round to nearest even
      qa[kk][i] = pack_f32(__uint_as_float(w << 16) * scale, __uint_as_float(w & 0xFFFF0000u) * scale);
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
  float m_run[2] = {-1e30f, -1e30f};
  float l_run[2] = {0.f, 0.f};
  // B fragment of the ones tile (K10): B[k][n] = 1 for n == 0, else 0; a lane
  // holds B[2tg .. 2tg+1][g] and B[2tg+8 .. 2tg+9][g], so the lanes with g == 0 hold two bf16 ones twice
  const uint32_t ones = (g == 0) ? 0x3F803F80u : 0u;

  for (int t = 0; t < ntiles; ++t) {
    int buf = 0;
    if constexpr (STAGES == 1) {
      load_now(t);
    } else {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
      __syncthreads();  // tile t is visible; every warp is done with tile t-1's buffer
      const int nxt = t + STAGES - 1;  // streams in while tile t is computed
      if (nxt < ntiles) load_tile(nxt, nxt % STAGES);
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
    float mx[2] = {m_run[0], m_run[1]};
    row_max(sc, mx);
    const float alpha[2] = {ex2(m_run[0] - mx[0]), ex2(m_run[1] - mx[1])};
    m_run[0] = mx[0];
    m_run[1] = mx[1];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = ex2(sc[nt][i] - mx[i >> 1]);
        if (VAR != V_ONES) rs[i >> 1] += p[i];
      }
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_f32(p[0], p[1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_f32(p[2], p[3]);
    }
    l_run[0] = l_run[0] * alpha[0] + rs[0];
    l_run[1] = l_run[1] * alpha[1] + rs[1];
#pragma unroll
    for (int dt = 0; dt < NACC; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
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
int launch(int BH, int N, int D, float scale, const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, __nv_bfloat16* o, cudaStream_t st) {
  const int smem = 2 * STAGES * BN * (DP + 8) * (int)sizeof(uint16_t);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(diag_bf16<DP, VAR, STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  diag_bf16<DP, VAR, STAGES><<<dim3(N / BM, BH), 128, smem, st>>>(q, k, v, o, N, D, scale);
  return (int)cudaGetLastError();
}

template <int VAR, int STAGES>
int launch_d(int BH, int N, int D, float scale, const __nv_bfloat16* q, const __nv_bfloat16* k,
             const __nv_bfloat16* v, __nv_bfloat16* o, cudaStream_t st) {
  if (D <= 16) return launch<16, VAR, STAGES>(BH, N, D, scale, q, k, v, o, st);
  if (D <= 32) return launch<32, VAR, STAGES>(BH, N, D, scale, q, k, v, o, st);
  if (D <= 64) return launch<64, VAR, STAGES>(BH, N, D, scale, q, k, v, o, st);
  return launch<128, VAR, STAGES>(BH, N, D, scale, q, k, v, o, st);
}

}  // namespace

// kind: 5 K8, 7 K10 (0-4 and 6, K7 and K9, are attn_diag_sm90.cu's). q, k,
// v, o: contiguous bf16 [BH, N, D], N % 64 == 0, D % 8 == 0, D <= 128 (K10:
// D < 128). scale: log2(e)/sqrt(d). block_k is not used (the kernels run
// 64-row kv tiles) and is kept for the signature. Returns
// cudaGetLastError() after the launch.
extern "C" int attn_diag(int kind, const void* q, const void* k, const void* v, void* o, int BH, int N, int D,
                         float scale, int block_k, void* stream) {
  if (N < BN || N % BN || D < 8 || D % 8 || D > 128 || BH < 1) return (int)cudaErrorInvalidValue;
  if (kind == 7 && D == 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto* qq = static_cast<const __nv_bfloat16*>(q);
  auto* kk = static_cast<const __nv_bfloat16*>(k);
  auto* vv = static_cast<const __nv_bfloat16*>(v);
  auto* oo = static_cast<__nv_bfloat16*>(o);
  switch (kind) {
    case 5: return launch_d<V_FLASH, 1>(BH, N, D, scale, qq, kk, vv, oo, st);
    case 7: return launch_d<V_ONES, 3>(BH, N, D, scale, qq, kk, vv, oo, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
