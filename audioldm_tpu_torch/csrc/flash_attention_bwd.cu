// K4 and K5: flash-attention backward, non-causal, unmasked.
//
// K4 `flash_bwd_dkv` replaces the Pallas TPU kernel `_flash_bwd_dkv_kernel`
// (audioldm_tpu/kernels/flash_attention.py:237, launched at :313) and K5
// `flash_bwd_dq` replaces `_flash_bwd_dq_kernel` (:264, launched at :340).
// Neither writes the [N, M] matrices to memory: from the forward's
// q2 = q * log2(e)/sqrt(d) (pre-scaled and rounded to the operand dtype by
// the wrapper, as the TPU kernels get it) each recomputes
//   P  = exp2(q2 k^T - lse2)                        (lse2 from K3)
//   dP = dO v^T
//   dS = P o (dP - delta) * scale                   (delta = rowsum(dO o O), given)
// and accumulates  dV = P^T dO,  dK = dS^T q2  (K4)  or  dQ = dS k  (K5)
// in fp32. P and dS are rounded to the operand dtype before their products,
// and K4 multiplies the fp32 dS^T q2 by dk_scale = 1/(scale * log2(e)) as it
// stores dK: the order of roundings of the TPU kernels
// (flash_attention.py:251-260, :274-281). Inputs are [B, H, N, D] with
// arbitrary (b, h, n) strides and a unit stride along d; lse2 and delta are
// contiguous fp32 [B, H, N].
//
// What bounds them on an H100: at [2, 8, 4096, 16] each recomputes 268 M
// exp2 (0.064 ms on the SFU) beside 34 (K4) or 26 (K5) GFLOP of bf16 matmul
// (0.035 / 0.026 ms) and ~10 MB of traffic: exp2 throughput, as K1.
//
// K4, bf16. On the TPU the q axis is a sequential grid dimension and dK/dV
// accumulate in the resident output block. Here one CTA of 4 warps owns a
// 64-row kv tile (16 rows a warp, K and V held as mma.sync A fragments),
// loops over 64-row q tiles and keeps dK and dV in registers: no atomics,
// the same result every run. It computes the transposed tiles S^T = K Q^T and
// dP^T = V dO^T, so P^T and dS^T come out as accumulator fragments that feed
// the next mma.sync as A operands directly, with the q rows as the k
// dimension; lse2 and delta are then per column and are read from shared
// memory. Q and dO tiles stream in with 16-byte cp.async copies, double
// buffered (one barrier a tile), row-major with a padded stride: read by
// 32-bit loads as the B operand of the first two products and by
// ldmatrix.trans as the B operand of the last two. q rows past N are zero
// with lse2 = +inf (P = 0); kv rows past M are not stored.
//
// K5, bf16. One CTA per 64-row q tile (Q and dO as A fragments, lse2 and
// delta in registers) loops over 64-row K/V tiles as K1 does; K is read by
// 32-bit loads for S and by ldmatrix.trans for dS K. kv columns past M get
// dS = 0.
//
// fp32 paths: one thread per kv row (K4) or q row (K5) with its rows and
// accumulators in registers and the other side's 32-row tiles in shared
// memory, plain fp32 FMA and exp2f.

#include <math.h>
#include <string.h>

#include "flash_common.cuh"

namespace {

constexpr int BM = 64;  // q rows per tile
constexpr int BN = 64;  // kv rows per tile
constexpr int TN = 32;  // rows per shared-memory tile of the fp32 kernels

// element strides (b, h, n) of q, k, v, dO and of the outputs (K4: dk, dv;
// K5: dq, unused)
struct Strides {
  long long qb, qh, qn, kb, kh, kn, vb, vh, vn, ob, oh, on, xb, xh, xn, yb, yh, yn;
};

template <int DP>
__device__ __forceinline__ void load_a_frags(uint32_t a[DP / 16][4], const __nv_bfloat16* base, long long stride,
                                             int row0, int rows, int D, int g, int tg) {
  // a0 (g, 2tg), a1 (g+8, 2tg), a2 (g, 2tg+8), a3 (g+8, 2tg+8)
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + (i & 1) * 8;
      const int col = kk * 16 + tg * 2 + (i >> 1) * 8;
      a[kk][i] = (row < rows && col < D) ? *reinterpret_cast<const uint32_t*>(base + (long long)row * stride + col) : 0u;
    }
  }
}

// Requires D % 8 == 0, 16-byte aligned tensors and (b, h, n) strides that
// are multiples of 8 elements (the wrapper pads and copies to get them).
template <int DP>
__global__ void __launch_bounds__(128) flash_bwd_dkv_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    int H, int N, int M, int D, Strides s, float scale, float dk_scale) {
  constexpr int KS = DP + 8;   // tile row stride (elements): 16-byte rows, no bank conflicts
  constexpr int CPR = DP / 8;  // 16-byte chunks per tile row
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Qs = smem;                                      // [2][BM][KS]
  uint16_t* Os = smem + 2 * BM * KS;                        // [2][BM][KS], dO
  float* Ls = reinterpret_cast<float*>(smem + 4 * BM * KS);  // [2][BM] lse2, +inf past N
  float* Ds = Ls + 2 * BM;                                  // [2][BM] delta

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const uint16_t* qp = reinterpret_cast<const uint16_t*>(q + b * s.qb + h * s.qh);
  const uint16_t* op = reinterpret_cast<const uint16_t*>(dout + b * s.ob + h * s.oh);
  const float* lp = lse + (long long)blockIdx.y * N;
  const float* dp_ = delta + (long long)blockIdx.y * N;
  const int c0 = blockIdx.x * BN + warp * 16;  // this warp's first kv row

  auto load_tile = [&](int t) {
    const int q0 = t * BM, buf = t & 1;
    for (int i = tid; i < BM * CPR; i += 128) {
      const int r = i / CPR, c = (i % CPR) * 8, row = q0 + r;
      uint16_t* dq_ = Qs + (buf * BM + r) * KS + c;
      uint16_t* do_ = Os + (buf * BM + r) * KS + c;
      if (row < N && c < D) {
        cp_async16(dq_, qp + (long long)row * s.qn + c);
        cp_async16(do_, op + (long long)row * s.on + c);
      } else {
        *reinterpret_cast<uint4*>(dq_) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(do_) = make_uint4(0, 0, 0, 0);
      }
    }
    if (tid < BM) {
      const int row = q0 + tid;
      Ls[buf * BM + tid] = row < N ? lp[row] : INFINITY;
      Ds[buf * BM + tid] = row < N ? dp_[row] : 0.f;
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int ntiles = (N + BM - 1) / BM;
  load_tile(0);

  uint32_t ka[DP / 16][4], va[DP / 16][4];
  load_a_frags<DP>(ka, k + b * s.kb + h * s.kh, s.kn, c0, M, D, g, tg);
  load_a_frags<DP>(va, v + b * s.vb + h * s.vh, s.vn, c0, M, D, g, tg);

  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[dt][i] = dva[dt][i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // tile t is visible; every warp is done with tile t-1's buffer
    if (t + 1 < ntiles) load_tile(t + 1);
    const int buf = t & 1;
    const uint16_t* Qt = Qs + buf * BM * KS;
    const uint16_t* Ot = Os + buf * BM * KS;
    const float* Lt = Ls + buf * BM;
    const float* Dt = Ds + buf * BM;

    // P^T and dS^T for this warp's 16 kv rows x 64 q columns, as bf16 A
    // fragments whose k dimension is the q row
    uint32_t pa[BM / 16][4], dsa[BM / 16][4];
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
      float st[4] = {0.f, 0.f, 0.f, 0.f}, dpt[4] = {0.f, 0.f, 0.f, 0.f};
      const uint16_t* qr = Qt + (nt * 8 + g) * KS + tg * 2;
      const uint16_t* orow = Ot + (nt * 8 + g) * KS + tg * 2;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        mma_bf16(st, ka[kk], *reinterpret_cast<const uint32_t*>(qr + kk * 16),
                 *reinterpret_cast<const uint32_t*>(qr + kk * 16 + 8));
        mma_bf16(dpt, va[kk], *reinterpret_cast<const uint32_t*>(orow + kk * 16),
                 *reinterpret_cast<const uint32_t*>(orow + kk * 16 + 8));
      }
      // c0,c1: kv row g, q columns 2tg, 2tg+1; c2,c3: kv row g+8
      const int col = nt * 8 + tg * 2;
      const float l2[2] = {Lt[col], Lt[col + 1]};
      const float dl[2] = {Dt[col], Dt[col + 1]};
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = ex2(st[i] - l2[i & 1]);
        ds[i] = p[i] * (dpt[i] - dl[i & 1]) * scale;
      }
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_f32(p[0], p[1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_f32(p[2], p[3]);
      dsa[nt >> 1][(nt & 1) * 2 + 0] = pack_f32(ds[0], ds[1]);
      dsa[nt >> 1][(nt & 1) * 2 + 1] = pack_f32(ds[2], ds[3]);
    }

    // dV += P^T dO and dK += dS^T Q; lane l addresses row (l & 15) of the
    // 16-row q block, at column d0 + 8 * (l >> 4)
#pragma unroll
    for (int j = 0; j < BM / 16; ++j) {
#pragma unroll
      for (int dt = 0; dt < DP / 8; dt += 2) {
        const int off = (j * 16 + (lane & 15)) * KS + (dt + (lane >> 4)) * 8;
        uint32_t bo[4], bq[4];
        ldmatrix_x4_trans(bo, Ot + off);
        mma_bf16(dva[dt], pa[j], bo[0], bo[1]);
        mma_bf16(dva[dt + 1], pa[j], bo[2], bo[3]);
        ldmatrix_x4_trans(bq, Qt + off);
        mma_bf16(dka[dt], dsa[j], bq[0], bq[1]);
        mma_bf16(dka[dt + 1], dsa[j], bq[2], bq[3]);
      }
    }
  }

  __nv_bfloat16* dkp = dk + b * s.xb + h * s.xh;
  __nv_bfloat16* dvp = dv + b * s.yb + h * s.yh;
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = c0 + g + r * 8;
      const int col = dt * 8 + tg * 2;
      if (row < M && col < D) {
        *reinterpret_cast<uint32_t*>(dkp + (long long)row * s.xn + col) =
            pack_f32(dka[dt][2 * r] * dk_scale, dka[dt][2 * r + 1] * dk_scale);
        *reinterpret_cast<uint32_t*>(dvp + (long long)row * s.yn + col) = pack_f32(dva[dt][2 * r], dva[dt][2 * r + 1]);
      }
    }
}

template <int DP>
__global__ void __launch_bounds__(128) flash_bwd_dq_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    int H, int N, int M, int D, Strides s, float scale) {
  constexpr int KS = DP + 8;
  constexpr int CPR = DP / 8;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Ks = smem;                // [2][BN][KS]
  uint16_t* Vs = smem + 2 * BN * KS;  // [2][BN][KS]

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const uint16_t* kp = reinterpret_cast<const uint16_t*>(k + b * s.kb + h * s.kh);
  const uint16_t* vp = reinterpret_cast<const uint16_t*>(v + b * s.vb + h * s.vh);
  const int r0 = blockIdx.x * BM + warp * 16;

  auto load_tile = [&](int t) {
    const int kv0 = t * BN, buf = (t & 1) * BN * KS;
    for (int i = tid; i < BN * CPR; i += 128) {
      const int r = i / CPR, c = (i % CPR) * 8, kv = kv0 + r;
      uint16_t* dk_ = Ks + buf + r * KS + c;
      uint16_t* dv_ = Vs + buf + r * KS + c;
      if (kv < M && c < D) {
        cp_async16(dk_, kp + (long long)kv * s.kn + c);
        cp_async16(dv_, vp + (long long)kv * s.vn + c);
      } else {
        *reinterpret_cast<uint4*>(dk_) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dv_) = make_uint4(0, 0, 0, 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int ntiles = (M + BN - 1) / BN;
  load_tile(0);

  uint32_t qa[DP / 16][4], oa[DP / 16][4];
  load_a_frags<DP>(qa, q + b * s.qb + h * s.qh, s.qn, r0, N, D, g, tg);
  load_a_frags<DP>(oa, dout + b * s.ob + h * s.oh, s.on, r0, N, D, g, tg);
  float l2[2], dl[2];  // rows g and g+8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + r * 8;
    l2[r] = row < N ? lse[(long long)blockIdx.y * N + row] : 0.f;
    dl[r] = row < N ? delta[(long long)blockIdx.y * N + row] : 0.f;
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int kv0 = t * BN;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (t + 1 < ntiles) load_tile(t + 1);
    const uint16_t* Kt = Ks + (t & 1) * BN * KS;
    const uint16_t* Vt = Vs + (t & 1) * BN * KS;
    const bool ragged = kv0 + BN > M;

    // dS for this warp's 16 q rows x 64 kv columns, as bf16 A fragments
    uint32_t dsa[BN / 16][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      float sc[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      const uint16_t* kr = Kt + (nt * 8 + g) * KS + tg * 2;
      const uint16_t* vr = Vt + (nt * 8 + g) * KS + tg * 2;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        mma_bf16(sc, qa[kk], *reinterpret_cast<const uint32_t*>(kr + kk * 16),
                 *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8));
        mma_bf16(dp, oa[kk], *reinterpret_cast<const uint32_t*>(vr + kk * 16),
                 *reinterpret_cast<const uint32_t*>(vr + kk * 16 + 8));
      }
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ex2(sc[i] - l2[i >> 1]);
        ds[i] = p * (dp[i] - dl[i >> 1]) * scale;
        if (ragged && kv0 + nt * 8 + tg * 2 + (i & 1) >= M) ds[i] = 0.f;  // kv columns past M
      }
      dsa[nt >> 1][(nt & 1) * 2 + 0] = pack_f32(ds[0], ds[1]);
      dsa[nt >> 1][(nt & 1) * 2 + 1] = pack_f32(ds[2], ds[3]);
    }

    // dQ += dS K, K as the [kv x d] B operand by ldmatrix.trans
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
#pragma unroll
      for (int dt = 0; dt < DP / 8; dt += 2) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, Kt + (j * 16 + (lane & 15)) * KS + (dt + (lane >> 4)) * 8);
        mma_bf16(acc[dt], dsa[j], bk[0], bk[1]);
        mma_bf16(acc[dt + 1], dsa[j], bk[2], bk[3]);
      }
    }
  }

  __nv_bfloat16* dqp = dq + b * s.xb + h * s.xh;
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + r * 8;
      const int col = dt * 8 + tg * 2;
      if (row < N && col < D)
        *reinterpret_cast<uint32_t*>(dqp + (long long)row * s.xn + col) = pack_f32(acc[dt][2 * r], acc[dt][2 * r + 1]);
    }
}

// fp32 K4: thread = kv row; k, v, dk, dv in registers
template <int DM>
__global__ void __launch_bounds__(128) flash_bwd_dkv_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int N, int M, int D, Strides s,
    float scale, float dk_scale) {
  __shared__ float Qs[TN][DM];
  __shared__ float Os[TN][DM];
  __shared__ float Ls[TN];
  __shared__ float Ds[TN];
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * 128 + tid;
  const float* qp = q + b * s.qb + h * s.qh;
  const float* op = dout + b * s.ob + h * s.oh;
  const float* lp = lse + (long long)blockIdx.y * N;
  const float* dp_ = delta + (long long)blockIdx.y * N;

  float kr[DM], vr[DM], dkr[DM], dvr[DM];
  const float* krow = k + b * s.kb + h * s.kh + (long long)min(row, M - 1) * s.kn;
  const float* vrow = v + b * s.vb + h * s.vh + (long long)min(row, M - 1) * s.vn;
#pragma unroll
  for (int d = 0; d < DM; ++d) {
    const bool ok = row < M && d < D;
    kr[d] = ok ? krow[d] : 0.f;
    vr[d] = ok ? vrow[d] : 0.f;
    dkr[d] = dvr[d] = 0.f;
  }
  for (int q0 = 0; q0 < N; q0 += TN) {
    __syncthreads();
    for (int idx = tid; idx < TN * DM; idx += 128) {
      const int r = idx / DM, c = idx % DM, qr = q0 + r;
      const bool ok = qr < N && c < D;
      Qs[r][c] = ok ? qp[qr * s.qn + c] : 0.f;
      Os[r][c] = ok ? op[qr * s.on + c] : 0.f;
    }
    if (tid < TN && q0 + tid < N) {
      Ls[tid] = lp[q0 + tid];
      Ds[tid] = dp_[q0 + tid];
    }
    __syncthreads();
    const int nq = min(TN, N - q0);
    for (int j = 0; j < nq; ++j) {
      float s2 = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DM; ++d) {
        s2 = fmaf(kr[d], Qs[j][d], s2);
        dp = fmaf(vr[d], Os[j][d], dp);
      }
      const float p = exp2f(s2 - Ls[j]);
      const float ds = p * (dp - Ds[j]) * scale;
#pragma unroll
      for (int d = 0; d < DM; ++d) {
        dvr[d] = fmaf(p, Os[j][d], dvr[d]);
        dkr[d] = fmaf(ds, Qs[j][d], dkr[d]);
      }
    }
  }
  if (row < M) {
    float* dkrow = dk + b * s.xb + h * s.xh + (long long)row * s.xn;
    float* dvrow = dv + b * s.yb + h * s.yh + (long long)row * s.yn;
#pragma unroll
    for (int d = 0; d < DM; ++d)
      if (d < D) {
        dkrow[d] = dkr[d] * dk_scale;
        dvrow[d] = dvr[d];
      }
  }
}

// fp32 K5: thread = q row; q2, dO, dq in registers
template <int DM>
__global__ void __launch_bounds__(128) flash_bwd_dq_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int H, int N, int M, int D, Strides s, float scale) {
  __shared__ float Ks[TN][DM];
  __shared__ float Vs[TN][DM];
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * 128 + tid;
  const float* kp = k + b * s.kb + h * s.kh;
  const float* vp = v + b * s.vb + h * s.vh;

  float q2[DM], dor[DM], acc[DM];
  const float* qrow = q + b * s.qb + h * s.qh + (long long)min(row, N - 1) * s.qn;
  const float* orow = dout + b * s.ob + h * s.oh + (long long)min(row, N - 1) * s.on;
#pragma unroll
  for (int d = 0; d < DM; ++d) {
    const bool ok = row < N && d < D;
    q2[d] = ok ? qrow[d] : 0.f;
    dor[d] = ok ? orow[d] : 0.f;
    acc[d] = 0.f;
  }
  const float l2 = row < N ? lse[(long long)blockIdx.y * N + row] : 0.f;
  const float dl = row < N ? delta[(long long)blockIdx.y * N + row] : 0.f;
  for (int kv0 = 0; kv0 < M; kv0 += TN) {
    __syncthreads();
    for (int idx = tid; idx < TN * DM; idx += 128) {
      const int r = idx / DM, c = idx % DM, kv = kv0 + r;
      const bool ok = kv < M && c < D;
      Ks[r][c] = ok ? kp[kv * s.kn + c] : 0.f;
      Vs[r][c] = ok ? vp[kv * s.vn + c] : 0.f;
    }
    __syncthreads();
    const int nv = min(TN, M - kv0);  // kv rows past M add nothing
    for (int j = 0; j < nv; ++j) {
      float s2 = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DM; ++d) {
        s2 = fmaf(q2[d], Ks[j][d], s2);
        dp = fmaf(dor[d], Vs[j][d], dp);
      }
      const float ds = exp2f(s2 - l2) * (dp - dl) * scale;
#pragma unroll
      for (int d = 0; d < DM; ++d) acc[d] = fmaf(ds, Ks[j][d], acc[d]);
    }
  }
  if (row < N) {
    float* dqrow = dq + b * s.xb + h * s.xh + (long long)row * s.xn;
#pragma unroll
    for (int d = 0; d < DM; ++d)
      if (d < D) dqrow[d] = acc[d];
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int DP>
int launch_dkv_bf16(dim3 grid, cudaStream_t st, const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int H, int N, int M, int D,
                    Strides s, float scale, float dk_scale) {
  const int smem = 2 * 2 * BM * (DP + 8) * (int)sizeof(uint16_t) + 2 * 2 * BM * (int)sizeof(float);
  if (const int err = set_smem(flash_bwd_dkv_bf16<DP>, smem)) return err;
  flash_bwd_dkv_bf16<DP><<<grid, 128, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, N, M, D, s, scale, dk_scale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dq_bf16(dim3 grid, cudaStream_t st, const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, int H, int N, int M, int D, Strides s,
                   float scale) {
  const int smem = 2 * 2 * BN * (DP + 8) * (int)sizeof(uint16_t);
  if (const int err = set_smem(flash_bwd_dq_bf16<DP>, smem)) return err;
  flash_bwd_dq_bf16<DP><<<grid, 128, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dq), H, N, M, D, s, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// is_bf16: 1 for bfloat16 tensors, 0 for float32. q: the pre-scaled q2.
// strides: 18 element strides (b, h, n) of q2, k, v, dO, dk, dv. lse and
// delta: contiguous fp32 [B, H, N]. scale: 1/sqrt(d); dk_scale: 1/(scale *
// log2(e)). Returns cudaGetLastError() after launch.
extern "C" int flash_bwd_dkv(int is_bf16, const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int B, int H, int N,
                             int M, int D, const long long* strides, float scale, float dk_scale,
                             void* stream) {
  Strides s;
  memcpy(&s, strides, sizeof(s));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto* ll = static_cast<const float*>(lse);
  auto* dd = static_cast<const float*>(delta);
  if (is_bf16) {
    const dim3 grid((M + BN - 1) / BN, B * H);
    if (D % 8) return (int)cudaErrorInvalidValue;
    if (D <= 16) return launch_dkv_bf16<16>(grid, st, q, k, v, dout, ll, dd, dk, dv, H, N, M, D, s, scale, dk_scale);
    if (D <= 32) return launch_dkv_bf16<32>(grid, st, q, k, v, dout, ll, dd, dk, dv, H, N, M, D, s, scale, dk_scale);
    if (D <= 64) return launch_dkv_bf16<64>(grid, st, q, k, v, dout, ll, dd, dk, dv, H, N, M, D, s, scale, dk_scale);
    return launch_dkv_bf16<128>(grid, st, q, k, v, dout, ll, dd, dk, dv, H, N, M, D, s, scale, dk_scale);
  }
  const dim3 grid((M + 127) / 128, B * H);
  auto* qq = static_cast<const float*>(q);
  auto* kk = static_cast<const float*>(k);
  auto* vv = static_cast<const float*>(v);
  auto* oo = static_cast<const float*>(dout);
  auto* dkk = static_cast<float*>(dk);
  auto* dvv = static_cast<float*>(dv);
  if (D <= 16) flash_bwd_dkv_f32<16><<<grid, 128, 0, st>>>(qq, kk, vv, oo, ll, dd, dkk, dvv, H, N, M, D, s, scale, dk_scale);
  else if (D <= 32) flash_bwd_dkv_f32<32><<<grid, 128, 0, st>>>(qq, kk, vv, oo, ll, dd, dkk, dvv, H, N, M, D, s, scale, dk_scale);
  else if (D <= 64) flash_bwd_dkv_f32<64><<<grid, 128, 0, st>>>(qq, kk, vv, oo, ll, dd, dkk, dvv, H, N, M, D, s, scale, dk_scale);
  else flash_bwd_dkv_f32<128><<<grid, 128, 0, st>>>(qq, kk, vv, oo, ll, dd, dkk, dvv, H, N, M, D, s, scale, dk_scale);
  return (int)cudaGetLastError();
}

// As flash_bwd_dkv; strides: (b, h, n) of q2, k, v, dO, dq (the last triple unused).
extern "C" int flash_bwd_dq(int is_bf16, const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int B, int H, int N, int M, int D,
                            const long long* strides, float scale, void* stream) {
  Strides s;
  memcpy(&s, strides, sizeof(s));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto* ll = static_cast<const float*>(lse);
  auto* dd = static_cast<const float*>(delta);
  if (is_bf16) {
    const dim3 grid((N + BM - 1) / BM, B * H);
    if (D % 8) return (int)cudaErrorInvalidValue;
    if (D <= 16) return launch_dq_bf16<16>(grid, st, q, k, v, dout, ll, dd, dq, H, N, M, D, s, scale);
    if (D <= 32) return launch_dq_bf16<32>(grid, st, q, k, v, dout, ll, dd, dq, H, N, M, D, s, scale);
    if (D <= 64) return launch_dq_bf16<64>(grid, st, q, k, v, dout, ll, dd, dq, H, N, M, D, s, scale);
    return launch_dq_bf16<128>(grid, st, q, k, v, dout, ll, dd, dq, H, N, M, D, s, scale);
  }
  const dim3 grid((N + 127) / 128, B * H);
  auto* qq = static_cast<const float*>(q);
  auto* kk = static_cast<const float*>(k);
  auto* vv = static_cast<const float*>(v);
  auto* oo = static_cast<const float*>(dout);
  auto* dqq = static_cast<float*>(dq);
  if (D <= 16) flash_bwd_dq_f32<16><<<grid, 128, 0, st>>>(qq, kk, vv, oo, ll, dd, dqq, H, N, M, D, s, scale);
  else if (D <= 32) flash_bwd_dq_f32<32><<<grid, 128, 0, st>>>(qq, kk, vv, oo, ll, dd, dqq, H, N, M, D, s, scale);
  else if (D <= 64) flash_bwd_dq_f32<64><<<grid, 128, 0, st>>>(qq, kk, vv, oo, ll, dd, dqq, H, N, M, D, s, scale);
  else flash_bwd_dq_f32<128><<<grid, 128, 0, st>>>(qq, kk, vv, oo, ll, dd, dqq, H, N, M, D, s, scale);
  return (int)cudaGetLastError();
}
