// K4 and K5 in fp32: flash-attention backward, non-causal, unmasked. bf16
// K4 and K5 are flash_bwd_sm90.cu's (Hopper: wgmma, a TMA ring, 128-row
// tiles), which replaced the bf16 kernels that lived here (mma.sync,
// 64-row tiles, a cp.async ring).
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
// stores dK (flash_attention.py:251-260, :274-281). Inputs are [B, H, N, D]
// with arbitrary (b, h, n) strides and a unit stride along d; lse2 and
// delta are contiguous fp32 [B, H, N].
//
// One thread per kv row (K4) or q row (K5) with its rows and accumulators
// in registers and the other side's 32-row tiles in shared memory, plain
// fp32 FMA and exp2f: at [2, 8, 4096, 16] the bound is the fp32 FMA rate
// (0.51 and 0.39 ms).

#include <math.h>
#include <string.h>

#include <cuda_runtime.h>

namespace {

constexpr int TN = 32;  // rows per shared-memory tile

// element strides (b, h, n) of q, k, v, dO and of the outputs (K4: dk, dv;
// K5: dq, unused)
struct Strides {
  long long qb, qh, qn, kb, kh, kn, vb, vh, vn, ob, oh, on, xb, xh, xn, yb, yh, yn;
};

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

}  // namespace

// fp32 K4 (is_bf16 must be 0). q: the pre-scaled q2.
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
  if (is_bf16) return (int)cudaErrorInvalidValue;  // bf16: flash_bwd_sm90.cu
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
  if (is_bf16) return (int)cudaErrorInvalidValue;  // bf16: flash_bwd_sm90.cu
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
