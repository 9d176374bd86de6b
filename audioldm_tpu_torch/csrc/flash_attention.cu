// K3, and K1 in fp32: flash-attention forward, non-causal, unmasked; K3
// with the logsumexp output that the backward kernels
// (flash_attention_bwd.cu) recompute the softmax from, K1 without. K1 in
// bf16 is flash_fwd_sm90.cu (wgmma, TMA, 128-row q tiles); the bf16 kernel
// here is its previous design, kept for K3 until the training kernels move
// onto that mainloop.
//
// K1 replaces the Pallas TPU kernel `_flash_kernel_nolse`
// (audioldm_tpu/kernels/flash_attention.py:128, launched by
// `_flash_bh(with_lse=False)` from `_flash_fwd_impl`); K3 replaces
// `_flash_kernel` (:86, launched by `_flash_bh` from `_flash_vjp_fwd`). In
// fp32 they are one kernel body, K3 (template LSE) with one store more per
// q row; the bf16 kernel is K3's alone. The store is
// lse2 = m + log2(l), the base-2 logsumexp of the scaled logits, into a
// contiguous fp32 [B, H, N] buffer (the TPU kernel broadcasts it over 128
// lanes; here it is 4 bytes a row). Masking the ragged kv tail to -inf
// matters doubly for K3: it also sets lse2.
//
// O = softmax(Q K^T / sqrt(d)) V over [B, H, N, D] with arbitrary (b, h, n)
// strides and a unit stride along d, so the UNet's q/k/v views of the
// projection outputs and the merged-heads output need no copies.
//
// What bounds it on an H100: at the UNet level-0 shape [2, 8, 4096, 16] the
// work is 16 * 4096^2 = 268 M exp2 against 17.2 GFLOP of matmul and 8.4 MB
// of q/k/v/o. The tensor cores would take ~17 us for the FLOPs and HBM ~3 us
// for the bytes, while the exp2 run on the SFU (16 per SM per clock): the
// kernel is bounded by exp2 throughput (~70 us). The design keeps the
// [N, M] logits in registers (never in memory) and does exactly one exp2
// per logit, plus one per row and tile for the running-max rescale.
//
// bf16 path (K3): one CTA of 4 warps per (b*h, 64-row q tile); each warp owns 16
// q rows as mma.sync m16n8k16 A fragments (loaded once). K and V tiles of
// 64 rows stream into shared memory with 16-byte cp.async copies, double
// buffered (tile t+1 loads while tile t is computed, one barrier a tile),
// row-major with a padded row stride so that neither the 32-bit K fragment
// loads nor the ldmatrix.trans V fragment loads conflict on banks. S = Q K^T
// is accumulated in fp32 and scaled by log2(e)/sqrt(d); kv columns past M
// are masked to -inf on the ragged last tile only. The online softmax
// (running max, sum, accumulator, all fp32; ex2.approx) feeds P as bf16 A
// fragments straight from the S accumulators into P V. The head dim is
// zero-padded to 16/32/64/128 inside shared memory only; it must be a
// multiple of 8 (the wrapper pads other head dims).
//
// fp32 path (taken by `--fp32` runs): one thread per q row with q and the
// accumulator in registers, K/V tiles of 32 rows in shared memory, plain
// fp32 FMA, and a rescale only when a row's running max grows.

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
__global__ void __launch_bounds__(128) flash_fwd_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    int H, int N, int M, int D, Strides s, float scale_log2) {
  constexpr int KS = DP + 8;  // K and V tile row stride (elements): 16-byte rows, no bank conflicts
  constexpr int CPR = DP / 8;  // 16-byte chunks per tile row
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Ks = smem;                 // [2][BN][KS]
  uint16_t* Vs = smem + 2 * BN * KS;   // [2][BN][KS]

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const __nv_bfloat16* qp = q + b * s.qb + h * s.qh;
  const uint16_t* kp = reinterpret_cast<const uint16_t*>(k + b * s.kb + h * s.kh);
  const uint16_t* vp = reinterpret_cast<const uint16_t*>(v + b * s.vb + h * s.vh);
  __nv_bfloat16* op = o + b * s.ob + h * s.oh;
  const int r0 = blockIdx.x * BM + warp * 16;

  // one 16-byte cp.async per (row, chunk) of K and of V; rows past M and
  // columns past D are zero
  auto load_tile = [&](int t) {
    const int kv0 = t * BN, buf = (t & 1) * BN * KS;
    for (int i = tid; i < BN * CPR; i += 128) {
      const int r = i / CPR, c = (i % CPR) * 8, kv = kv0 + r;
      uint16_t* dk = Ks + buf + r * KS + c;
      uint16_t* dv = Vs + buf + r * KS + c;
      if (kv < M && c < D) {
        cp_async16(dk, kp + (long long)kv * s.kn + c);
        cp_async16(dv, vp + (long long)kv * s.vn + c);
      } else {
        *reinterpret_cast<uint4*>(dk) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dv) = make_uint4(0, 0, 0, 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int ntiles = (M + BN - 1) / BN;
  load_tile(0);

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

  float acc[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  float m_run[2] = {-1e30f, -1e30f};
  float l_run[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int kv0 = t * BN;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // tile t is visible; every warp is done with tile t-1's buffer
    if (t + 1 < ntiles) load_tile(t + 1);  // streams in while tile t is computed
    const uint16_t* Kt = Ks + (t & 1) * BN * KS;
    const uint16_t* Vt = Vs + (t & 1) * BN * KS;

    // S = Q K^T for this warp's 16 rows x 64 kv columns (8 n-tiles of 8)
    float sc[BN / 8][4];
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

    // online softmax in base 2; c0,c1 belong to row g, c2,c3 to row g+8
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] *= scale_log2;
    if (kv0 + BN > M) {  // ragged last tile: kv columns past M get no weight
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (kv0 + nt * 8 + tg * 2 + (i & 1) >= M) sc[nt][i] = -INFINITY;
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], sc[nt][i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const float alpha[2] = {ex2(m_run[0] - mx[0]), ex2(m_run[1] - mx[1])};
    m_run[0] = mx[0];
    m_run[1] = mx[1];

    // P = exp2(S - m) straight into bf16 A fragments for P V (k = kv)
    uint32_t pa[BN / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = ex2(sc[nt][i] - mx[i >> 1]);
        rs[i >> 1] += p[i];
      }
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_f32(p[0], p[1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_f32(p[2], p[3]);
    }
    l_run[0] = l_run[0] * alpha[0] + rs[0];
    l_run[1] = l_run[1] * alpha[1] + rs[1];

#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
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
      for (int dt = 0; dt < DP / 8; dt += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vt + (j * 16 + (lane & 15)) * KS + (dt + (lane >> 4)) * 8);
        mma_bf16(acc[dt], pa[j], bv[0], bv[1]);
        mma_bf16(acc[dt + 1], pa[j], bv[2], bv[3]);
      }
    }
  }

  // each thread summed only its own columns: finish the row sums in the quad
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
  if (tg == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + r * 8;
      if (row < N) lse[(long long)blockIdx.y * N + row] = m_run[r] + log2f(l_run[r]);
    }
  }
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + r * 8;
      const int col = dt * 8 + tg * 2;
      if (row < N && col < D)
        *reinterpret_cast<uint32_t*>(op + (long long)row * s.on + col) =
            pack_f32(acc[dt][2 * r] * inv[r], acc[dt][2 * r + 1] * inv[r]);
    }
}

template <int DM, bool LSE>
__global__ void __launch_bounds__(128) flash_fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int H, int N, int M, int D, Strides s,
    float scale_log2) {
  constexpr int TN = 32;
  __shared__ float Ks[TN][DM];
  __shared__ float Vs[TN][DM];
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * 128 + tid;
  const float* kp = k + b * s.kb + h * s.kh;
  const float* vp = v + b * s.vb + h * s.vh;

  float qr[DM], acc[DM];
  const float* qrow = q + b * s.qb + h * s.qh + (long long)min(row, N - 1) * s.qn;
#pragma unroll
  for (int d = 0; d < DM; ++d) {
    qr[d] = (row < N && d < D) ? qrow[d] * scale_log2 : 0.f;
    acc[d] = 0.f;
  }
  float m = -1e30f, l = 0.f;
  for (int kv0 = 0; kv0 < M; kv0 += TN) {
    __syncthreads();
    for (int idx = tid; idx < TN * DM; idx += 128) {
      const int r = idx / DM, c = idx % DM, kv = kv0 + r;
      const bool ok = kv < M && c < D;
      Ks[r][c] = ok ? kp[kv * s.kn + c] : 0.f;
      Vs[r][c] = ok ? vp[kv * s.vn + c] : 0.f;
    }
    __syncthreads();
    const int nv = min(TN, M - kv0);
    for (int j = 0; j < nv; ++j) {
      float sc = 0.f;
#pragma unroll
      for (int d = 0; d < DM; ++d) sc = fmaf(qr[d], Ks[j][d], sc);
      if (sc > m) {
        const float a = exp2f(m - sc);
        l *= a;
#pragma unroll
        for (int d = 0; d < DM; ++d) acc[d] *= a;
        m = sc;
      }
      const float p = exp2f(sc - m);
      l += p;
#pragma unroll
      for (int d = 0; d < DM; ++d) acc[d] = fmaf(p, Vs[j][d], acc[d]);
    }
  }
  if (row < N) {
    float* orow = o + b * s.ob + h * s.oh + (long long)row * s.on;
    const float inv = 1.f / l;
    for (int d = 0; d < D; ++d) orow[d] = acc[d] * inv;
    if (LSE) lse[(long long)blockIdx.y * N + row] = m + log2f(l);
  }
}

template <int DP>
int launch_bf16(dim3 grid, cudaStream_t st, const __nv_bfloat16* q, const __nv_bfloat16* k,
                const __nv_bfloat16* v, __nv_bfloat16* o, float* lse, int H, int N, int M, int D,
                Strides s, float scale_log2) {
  const int smem = 2 * 2 * BN * (DP + 8) * (int)sizeof(uint16_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16<DP>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  flash_fwd_bf16<DP><<<grid, 128, smem, st>>>(q, k, v, o, lse, H, N, M, D, s, scale_log2);
  return (int)cudaGetLastError();
}

template <bool LSE>
int launch(int is_bf16, const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
           int N, int M, int D, const long long* strides, float scale_log2, void* stream) {
  Strides s;
  memcpy(&s, strides, sizeof(s));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {  // K3 (bf16 K1 is flash_fwd_sm90.cu)
    const dim3 grid((N + BM - 1) / BM, B * H);
    auto* qq = static_cast<const __nv_bfloat16*>(q);
    auto* kk = static_cast<const __nv_bfloat16*>(k);
    auto* vv = static_cast<const __nv_bfloat16*>(v);
    auto* oo = static_cast<__nv_bfloat16*>(o);
    if (D % 8) return (int)cudaErrorInvalidValue;
    if (D <= 16) return launch_bf16<16>(grid, st, qq, kk, vv, oo, lse, H, N, M, D, s, scale_log2);
    if (D <= 32) return launch_bf16<32>(grid, st, qq, kk, vv, oo, lse, H, N, M, D, s, scale_log2);
    if (D <= 64) return launch_bf16<64>(grid, st, qq, kk, vv, oo, lse, H, N, M, D, s, scale_log2);
    return launch_bf16<128>(grid, st, qq, kk, vv, oo, lse, H, N, M, D, s, scale_log2);
  }
  const dim3 grid((N + 127) / 128, B * H);
  auto* qq = static_cast<const float*>(q);
  auto* kk = static_cast<const float*>(k);
  auto* vv = static_cast<const float*>(v);
  auto* oo = static_cast<float*>(o);
  if (D <= 16) flash_fwd_f32<16, LSE><<<grid, 128, 0, st>>>(qq, kk, vv, oo, lse, H, N, M, D, s, scale_log2);
  else if (D <= 32) flash_fwd_f32<32, LSE><<<grid, 128, 0, st>>>(qq, kk, vv, oo, lse, H, N, M, D, s, scale_log2);
  else if (D <= 64) flash_fwd_f32<64, LSE><<<grid, 128, 0, st>>>(qq, kk, vv, oo, lse, H, N, M, D, s, scale_log2);
  else flash_fwd_f32<128, LSE><<<grid, 128, 0, st>>>(qq, kk, vv, oo, lse, H, N, M, D, s, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// K1 in fp32 (bf16 K1 is flash_fwd_sm90). strides: 12 element strides
// (b, h, n) of q, k, v, o. Returns cudaGetLastError() after launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int M, int D,
                         const long long* strides, float scale_log2, void* stream) {
  return launch<false>(0, q, k, v, o, nullptr, B, H, N, M, D, strides, scale_log2, stream);
}

// K3 (is_bf16: 1 for bfloat16 tensors, 0 for float32): as flash_fwd, and
// writes lse2 into the contiguous fp32 [B, H, N] buffer `lse`.
extern "C" int flash_fwd_lse(int is_bf16, const void* q, const void* k, const void* v, void* o,
                             void* lse, int B, int H, int N, int M, int D, const long long* strides,
                             float scale_log2, void* stream) {
  return launch<true>(is_bf16, q, k, v, o, static_cast<float*>(lse), B, H, N, M, D, strides,
                      scale_log2, stream);
}
