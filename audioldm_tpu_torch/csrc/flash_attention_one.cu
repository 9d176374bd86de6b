// K6 in fp32: one-pass flash-attention forward for a single kv block,
// non-causal, unmasked, no logsumexp output (inference only). K6 in bf16 is
// flash_fwd_sm90.cu, on the wgmma/TMA mainloop of K1.
//
// It replaces the Pallas TPU kernel `_flash_kernel_one`
// (audioldm_tpu/kernels/flash_attention.py:133, selected by `_flash_bh` when
// the whole kv axis is one block, no lse is wanted and `_ONE_PASS` is on).
// The function is K1's, O = softmax(Q K^T / sqrt(d)) V over [B, H, N, D],
// but the arithmetic is not: the row max m is taken over the WHOLE row first,
// so there is no running max and no rescale of the accumulator, and the
// denominator l is the sum that a column of ones appended to V gives.
//
// What bounds it on an H100: the fp32 FMA rate (4 FLOP a logit for the two
// products), far above the HBM time.
//
// SIMT, one thread per q row as in the fp32 K1's first design (the fp32 K1
// now runs 3xTF32 on wgmma, flash_attention.cu): a first loop over K for the
// row max, a second over K and V with l as one more accumulator (fp32 P
// needs no rounding; the "ones column" is the FMA l += p * 1). kv rows past
// M are left out of both loops.

#include <math.h>
#include <string.h>

#include <cuda_runtime.h>

namespace {

struct Strides {
  long long qb, qh, qn, kb, kh, kn, vb, vh, vn, ob, oh, on;
};

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

}  // namespace

// K6 in fp32 (bf16 K6 is flash_fwd_sm90). strides: 12 element strides
// (b, h, n) of q, k, v, o. Returns cudaGetLastError() after launch.
extern "C" int flash_fwd_one(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int M, int D,
                             const long long* strides, float scale_log2, void* stream) {
  Strides s;
  memcpy(&s, strides, sizeof(s));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D < 1 || D > 128 || M < 1) return (int)cudaErrorInvalidValue;
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
