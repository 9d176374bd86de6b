// K1 and K3 in fp32: flash-attention forward, non-causal, unmasked; K3
// with the logsumexp output that the backward kernels
// (flash_attention_bwd.cu) recompute the softmax from, K1 without. In bf16
// both are flash_fwd_sm90.cu (wgmma, TMA, 128-row q tiles).
//
// K1 replaces the Pallas TPU kernel `_flash_kernel_nolse`
// (audioldm_tpu/kernels/flash_attention.py:128, launched by
// `_flash_bh(with_lse=False)` from `_flash_fwd_impl`); K3 replaces
// `_flash_kernel` (:86, launched by `_flash_bh` from `_flash_vjp_fwd`). They
// are one kernel body, K3 (template LSE) with one store more per q row:
// lse2 = m + log2(l), the base-2 logsumexp of the scaled logits, into a
// contiguous fp32 [B, H, N] buffer (the TPU kernel broadcasts it over 128
// lanes; here it is 4 bytes a row). K3 is handed q2 = q * log2(e)/sqrt(d)
// with scale_log2 = 1 (fp32 q2 is the same product as the kernel's own).
//
// O = softmax(Q K^T / sqrt(d)) V over [B, H, N, D] with arbitrary (b, h, n)
// strides and a unit stride along d, so the UNet's q/k/v views of the
// projection outputs and the merged-heads output need no copies.
//
// What bounds it on an H100: at [2, 8, 4096, 16] 17.2 GFLOP of fp32 FMA
// (0.256 ms at 67 TFLOP/s) against 268 M exp2 and 16.8 MB of q/k/v/o. The
// design (taken by `--fp32` runs only): one thread per q row with q and the
// accumulator in registers, K/V tiles of 32 rows in shared memory, plain
// fp32 FMA, and a rescale only when a row's running max grows.

#include <math.h>
#include <string.h>

#include <cuda_runtime.h>

namespace {

struct Strides {
  long long qb, qh, qn, kb, kh, kn, vb, vh, vn, ob, oh, on;
};

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

template <bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int N, int M, int D,
           const long long* strides, float scale_log2, void* stream) {
  Strides s;
  memcpy(&s, strides, sizeof(s));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
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
  return launch<false>(q, k, v, o, nullptr, B, H, N, M, D, strides, scale_log2, stream);
}

// K3 in fp32 (bf16 K3 is flash_fwd_sm90_lse): as flash_fwd, and writes lse2
// into the contiguous fp32 [B, H, N] buffer `lse`.
extern "C" int flash_fwd_lse(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int N,
                             int M, int D, const long long* strides, float scale_log2, void* stream) {
  return launch<true>(q, k, v, o, static_cast<float*>(lse), B, H, N, M, D, strides, scale_log2, stream);
}
