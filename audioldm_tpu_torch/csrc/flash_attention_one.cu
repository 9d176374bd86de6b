// K6: one-pass flash-attention forward for a single kv block, non-causal,
// unmasked, no logsumexp output (inference only).
//
// It replaces the Pallas TPU kernel `_flash_kernel_one`
// (audioldm_tpu/kernels/flash_attention.py:133, selected by `_flash_bh` when
// the whole kv axis is one block, no lse is wanted and `_ONE_PASS` is on).
// The function is K1's, O = softmax(Q K^T / sqrt(d)) V over [B, H, N, D],
// but the arithmetic is not: the row max m is taken over the WHOLE row first,
// so there is no running max, no alpha and no rescale of the accumulator;
// P = exp2(S - m) is rounded to v's dtype; and the denominator l is not
// summed by the threads but comes out of the second tensor-core product,
// [O | l] = P [V | 1], as the column that a column of ones appended to V
// gives. l is therefore the fp32 sum of the ROUNDED P (K1 sums the fp32 P).
//
// What bounds it on an H100: as K1, one exp2 per logit on the SFU (268 M at
// [2, 8, 4096, 16], ~64 us), far above the tensor-core and HBM times.
//
// The TPU kernel holds a [512, 4096] block of logits in VMEM. A CTA here has
// 227 KB, so a 64-row q tile cannot keep its 4096 logits a row (1 MiB in
// fp32) anywhere. The kernel sweeps K twice instead:
//   sweep 1: S = Q K^T tile by tile, row max only (no scale, no exp2: the
//            scale is positive, so max(S * c) = max(S) * c);
//   sweep 2: S again, P = exp2(S * c - m) into bf16 A fragments, P [V | 1].
// At d = 16 a 16 x 64 tile of S is 8 mma.sync, cheap next to its 1024 exp2,
// and the second sweep finds K in L2 (128 KB a head). K and V tiles of 64
// rows stream through the double-buffered cp.async pipeline of K1; the
// prefetch runs on across the boundary of the two sweeps. Keeping K resident
// in shared memory across both sweeps (128 KB a head at d = 16, but 192 KB
// with the conflict-free row stride and not at all from d = 32 on) was
// weighed and not built: it saves a second read of K from L2, which is not
// what bounds the kernel.
//
// The ones column never exists in memory. The B operand of mma.sync
// m16n8k16 for an 8-wide n-tile whose column 0 is all ones and whose columns
// 1..7 are zero is a constant per lane (lanes 0..3 hold column 0: both
// registers 0x3F803F80, two bf16 ones; every other lane 0), so the PV product
// gets one more n-tile (3 instead of 2 at d = 16) whose B fragment is that
// constant. The TPU wrapper writes the column into V's lane padding in HBM;
// here no tensor changes shape and no byte moves for it. Column 0 of the
// extra accumulator tile, held by the lanes with tg == 0, is l.
//
// kv columns past M are masked to -inf in both sweeps on the ragged last
// tile, so they get P = 0 and add nothing to O or l.
//
// fp32 path: SIMT, one thread per q row as in K1: a first loop over K for
// the row max, a second over K and V with l as one more accumulator (fp32 P
// needs no rounding; the "ones column" is the FMA l += p * 1).

#include <math.h>
#include <string.h>

#include "flash_common.cuh"

namespace {

constexpr int BM = 64;  // q rows per CTA (16 per warp)
constexpr int BN = 64;  // kv rows per shared-memory tile

struct Strides {
  long long qb, qh, qn, kb, kh, kn, vb, vh, vn, ob, oh, on;
};

// Requires D % 8 == 0, 16-byte aligned q/k/v/o and (b, h, n) strides that
// are multiples of 8 elements (the wrapper pads and copies to get them).
template <int DP>
__global__ void __launch_bounds__(128) flash_one_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int H, int N, int M, int D, Strides s, float scale_log2) {
  constexpr int KS = DP + 8;   // K and V tile row stride (elements): 16-byte rows, no bank conflicts
  constexpr int CPR = DP / 8;  // 16-byte chunks per tile row
  constexpr int NT = DP / 8;   // n-tiles of V; the ones tile is n-tile NT of the PV product
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Ks = smem;                // [2][BN][KS]
  uint16_t* Vs = smem + 2 * BN * KS;  // [2][BN][KS]

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const __nv_bfloat16* qp = q + b * s.qb + h * s.qh;
  const uint16_t* kp = reinterpret_cast<const uint16_t*>(k + b * s.kb + h * s.kh);
  const uint16_t* vp = reinterpret_cast<const uint16_t*>(v + b * s.vb + h * s.vh);
  __nv_bfloat16* op = o + b * s.ob + h * s.oh;
  const int r0 = blockIdx.x * BM + warp * 16;
  const int ntiles = (M + BN - 1) / BN;

  // Stage st < ntiles is sweep 1 (K tile st), stage st >= ntiles is sweep 2
  // (K and V tile st - ntiles); stage st lives in buffer st & 1. One 16-byte
  // cp.async per (row, chunk); rows past M and columns past D are zero.
  auto load_stage = [&](int st) {
    const bool with_v = st >= ntiles;
    const int kv0 = (with_v ? st - ntiles : st) * BN, buf = (st & 1) * BN * KS;
    for (int i = tid; i < BN * CPR; i += 128) {
      const int r = i / CPR, c = (i % CPR) * 8, kv = kv0 + r;
      uint16_t* dk = Ks + buf + r * KS + c;
      uint16_t* dv = Vs + buf + r * KS + c;
      if (kv < M && c < D) {
        cp_async16(dk, kp + (long long)kv * s.kn + c);
        if (with_v) cp_async16(dv, vp + (long long)kv * s.vn + c);
      } else {
        *reinterpret_cast<uint4*>(dk) = make_uint4(0, 0, 0, 0);
        if (with_v) *reinterpret_cast<uint4*>(dv) = make_uint4(0, 0, 0, 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  load_stage(0);

  // Q as A fragments: a0 (g, 2tg), a1 (g+8, 2tg), a2 (g, 2tg+8), a3 (g+8, 2tg+8)
  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + g + (i & 1) * 8;
      const int col = kk * 16 + tg * 2 + (i >> 1) * 8;
      qa[kk][i] = (row < N && col < D) ? *reinterpret_cast<const uint32_t*>(qp + (long long)row * s.qn + col) : 0u;
    }
  }

  // raw S = Q K^T of this warp's 16 rows x 64 kv columns (8 n-tiles of 8);
  // c0,c1 belong to row g, c2,c3 to row g+8. kv columns past M become -inf.
  auto logits = [&](const uint16_t* Kt, int kv0, float (&sc)[BN / 8][4]) {
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
    if (kv0 + BN > M) {  // ragged last tile: kv columns past M get no weight
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (kv0 + nt * 8 + tg * 2 + (i & 1) >= M) sc[nt][i] = -INFINITY;
    }
  };

  // sweep 1: the max of every whole row
  float mx[2] = {-INFINITY, -INFINITY};
  for (int st = 0; st < ntiles; ++st) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // stage st is visible; every warp is done with stage st-1's buffer
    load_stage(st + 1);  // the last one is tile 0 of sweep 2
    float sc[BN / 8][4];
    logits(Ks + (st & 1) * BN * KS, st * BN, sc);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], sc[nt][i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mx[r] *= scale_log2;  // m of the scaled logits
  }

  // sweep 2: [O | l] = P [V | 1]
  float acc[NT + 1][4];
#pragma unroll
  for (int dt = 0; dt <= NT; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  // B fragment of the ones tile: B[k][n] = 1 for n == 0, else 0; a lane holds
  // B[2tg .. 2tg+1][g] and B[2tg+8 .. 2tg+9][g], so the lanes with g == 0 hold two bf16 ones twice
  const uint32_t ones = (g == 0) ? 0x3F803F80u : 0u;

  for (int st = ntiles; st < 2 * ntiles; ++st) {
    const int kv0 = (st - ntiles) * BN;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (st + 1 < 2 * ntiles) load_stage(st + 1);
    const uint16_t* Vt = Vs + (st & 1) * BN * KS;
    float sc[BN / 8][4];
    logits(Ks + (st & 1) * BN * KS, kv0, sc);

    // P = exp2(S * c - m), rounded to bf16, straight into A fragments (k = kv)
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ex2(fmaf(sc[nt][i], scale_log2, -mx[i >> 1]));
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_f32(p[0], p[1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_f32(p[2], p[3]);
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
      mma_bf16(acc[NT], pa[j], ones, ones);  // the ones column: acc[NT] column 0 += rowsum(P)
    }
  }

  // l is column 0 of the ones tile: c0 (row g) and c2 (row g+8) of the lanes with tg == 0
  const float l[2] = {__shfl_sync(0xffffffffu, acc[NT][0], lane & ~3), __shfl_sync(0xffffffffu, acc[NT][2], lane & ~3)};
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int dt = 0; dt < NT; ++dt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + r * 8;
      const int col = dt * 8 + tg * 2;
      if (row < N && col < D)
        *reinterpret_cast<uint32_t*>(op + (long long)row * s.on + col) =
            pack_f32(acc[dt][2 * r] * inv[r], acc[dt][2 * r + 1] * inv[r]);
    }
}

template <int DM>
__global__ void __launch_bounds__(128) flash_one_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int H, int N, int M, int D, Strides s, float scale_log2) {
  constexpr int TN = 32;
  __shared__ float Ks[TN][DM];
  __shared__ float Vs[TN][DM];
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * 128 + tid;
  const float* kp = k + b * s.kb + h * s.kh;
  const float* vp = v + b * s.vb + h * s.vh;

  float qr[DM];
  const float* qrow = q + b * s.qb + h * s.qh + (long long)min(row, N - 1) * s.qn;
#pragma unroll
  for (int d = 0; d < DM; ++d) qr[d] = (row < N && d < D) ? qrow[d] : 0.f;

  // sweep 1: the max of the whole row (of the raw logits: the scale is positive)
  float m = -INFINITY;
  for (int kv0 = 0; kv0 < M; kv0 += TN) {
    __syncthreads();
    for (int idx = tid; idx < TN * DM; idx += 128) {
      const int r = idx / DM, c = idx % DM, kv = kv0 + r;
      Ks[r][c] = (kv < M && c < D) ? kp[kv * s.kn + c] : 0.f;
    }
    __syncthreads();
    const int nv = min(TN, M - kv0);  // kv rows past M get no weight
    for (int j = 0; j < nv; ++j) {
      float sc = 0.f;
#pragma unroll
      for (int d = 0; d < DM; ++d) sc = fmaf(qr[d], Ks[j][d], sc);
      m = fmaxf(m, sc);
    }
  }
  m *= scale_log2;

  // sweep 2: [O | l] = P [V | 1], l as one more accumulator
  float acc[DM], l = 0.f;
#pragma unroll
  for (int d = 0; d < DM; ++d) acc[d] = 0.f;
  for (int kv0 = 0; kv0 < M; kv0 += TN) {
    __syncthreads();
    for (int idx = tid; idx < TN * DM; idx += 128) {
      const int r = idx / DM, c = idx % DM, kv = kv0 + r;
      const bool ok = kv < M && c < D;
      Ks[r][c] = ok ? kp[kv * s.kn + c] : 0.f;
      Vs[r][c] = ok ? vp[kv * s.vn + c] : 0.f;
    }
    __syncthreads();
    const int nv2 = min(TN, M - kv0);  // kv rows past M get no weight
    for (int j = 0; j < nv2; ++j) {
      float sc = 0.f;
#pragma unroll
      for (int d = 0; d < DM; ++d) sc = fmaf(qr[d], Ks[j][d], sc);
      const float p = exp2f(fmaf(sc, scale_log2, -m));
      l = fmaf(p, 1.f, l);  // the ones column
#pragma unroll
      for (int d = 0; d < DM; ++d) acc[d] = fmaf(p, Vs[j][d], acc[d]);
    }
  }
  if (row < N) {
    float* orow = o + b * s.ob + h * s.oh + (long long)row * s.on;
    const float inv = 1.f / l;
    for (int d = 0; d < D; ++d) orow[d] = acc[d] * inv;
  }
}

template <int DP>
int launch_bf16(dim3 grid, cudaStream_t st, const __nv_bfloat16* q, const __nv_bfloat16* k,
                const __nv_bfloat16* v, __nv_bfloat16* o, int H, int N, int M, int D, Strides s,
                float scale_log2) {
  const int smem = 2 * 2 * BN * (DP + 8) * (int)sizeof(uint16_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(flash_one_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  flash_one_bf16<DP><<<grid, 128, smem, st>>>(q, k, v, o, H, N, M, D, s, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// K6. is_bf16: 1 for bfloat16 tensors, 0 for float32. strides: 12 element
// strides (b, h, n) of q, k, v, o. Returns cudaGetLastError() after launch.
extern "C" int flash_fwd_one(int is_bf16, const void* q, const void* k, const void* v, void* o,
                             int B, int H, int N, int M, int D, const long long* strides,
                             float scale_log2, void* stream) {
  Strides s;
  memcpy(&s, strides, sizeof(s));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D < 1 || D > 128 || M < 1) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    const dim3 grid((N + BM - 1) / BM, B * H);
    auto* qq = static_cast<const __nv_bfloat16*>(q);
    auto* kk = static_cast<const __nv_bfloat16*>(k);
    auto* vv = static_cast<const __nv_bfloat16*>(v);
    auto* oo = static_cast<__nv_bfloat16*>(o);
    if (D % 8) return (int)cudaErrorInvalidValue;
    if (D <= 16) return launch_bf16<16>(grid, st, qq, kk, vv, oo, H, N, M, D, s, scale_log2);
    if (D <= 32) return launch_bf16<32>(grid, st, qq, kk, vv, oo, H, N, M, D, s, scale_log2);
    if (D <= 64) return launch_bf16<64>(grid, st, qq, kk, vv, oo, H, N, M, D, s, scale_log2);
    return launch_bf16<128>(grid, st, qq, kk, vv, oo, H, N, M, D, s, scale_log2);
  }
  const dim3 grid((N + 127) / 128, B * H);
  auto* qq = static_cast<const float*>(q);
  auto* kk = static_cast<const float*>(k);
  auto* vv = static_cast<const float*>(v);
  auto* oo = static_cast<float*>(o);
  if (D <= 16) flash_one_f32<16><<<grid, 128, 0, st>>>(qq, kk, vv, oo, H, N, M, D, s, scale_log2);
  else if (D <= 32) flash_one_f32<32><<<grid, 128, 0, st>>>(qq, kk, vv, oo, H, N, M, D, s, scale_log2);
  else if (D <= 64) flash_one_f32<64><<<grid, 128, 0, st>>>(qq, kk, vv, oo, H, N, M, D, s, scale_log2);
  else flash_one_f32<128><<<grid, 128, 0, st>>>(qq, kk, vv, oo, H, N, M, D, s, scale_log2);
  return (int)cudaGetLastError();
}
