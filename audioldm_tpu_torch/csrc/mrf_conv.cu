// K2: one fused HiFi-GAN multi-receptive-field (MRF) stage, fp32.
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
// MB per stage), so the kernel is bounded by fp32 FMA throughput. The design
// keeps the whole 18-conv chain on chip: one CTA per (batch, 128-sample
// tile) holds the tile plus a 64-sample halo on each side (the chain's
// receptive field is 60, +3 for conv_post) as two [C, 256] fp32 buffers in
// shared memory (residual v and intermediate h) plus the [C, 144] resblock
// sum. Each conv keeps only the positions later convs still need (the
// margin shrinks conv by conv) but computes all 256, 2x the output tile, so
// that its tap loop has no branches.
// A warp owns 8 output channels x 256 positions (8 per lane, 32 apart, so
// the shared-memory reads are conflict-free); per input channel and tap it
// reads 8 weights (a broadcast float4 pair) and 8 inputs, and issues 64 FMAs.
// The weights (packed [ci][tap][co] by the wrapper) are staged in shared
// memory 4 input channels at a time with cp.async, double buffered, so no
// FMA waits on L2: at C=64 the two activation buffers leave L1 too small to
// hold a conv's weights. The tap loop is unrolled (K is a template
// parameter), which lets the compiler issue a tap's loads ahead of its FMAs;
// it is compiled for the resblock kernel sizes of audioldm-s, 3, 7 and 11.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TT = 128;        // output samples per CTA
constexpr int HALO = 64;       // samples of context on each side
constexpr int L = TT + 2 * HALO;  // 256 positions computed per buffer
constexpr int G = 32;          // zero guard on each side of a buffer row (>= max conv pad)
constexpr int LS = L + 2 * G;  // buffer row stride
constexpr int AM = 8;          // acc margin on each side (>= post pad)
constexpr int AW = TT + 2 * AM;
constexpr int CB = 4;          // input channels per staged weight chunk
constexpr int MAXR = 3, MAXU = 3;  // resblocks per stage, units per resblock

struct Cfg {
  int nres, nunit, C, CP, T, post_k, kmax;
  int ks[MAXR];
  int dil[MAXR][MAXU];
  float slope;
};

// leaky ReLU for a slope in [0, 1] (the wrapper checks it)
__device__ __forceinline__ float leaky(float x, float s) { return fmaxf(x, x * s); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Copy `n` floats (a multiple of 4, 16-byte aligned) to shared memory.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n) {
  for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4) cp_async16(dst + i, src + i);
  cp_async_commit();
}

// One conv of the chain; only buffer positions [HALO - margin, HALO + TT +
// margin) are kept. Every lane computes all 8 of its positions, so the tap
// loop has no branches and a tap's 10 loads can be issued ahead of its 64
// FMAs; positions outside the margin are discarded (read within the guard).
// CONV1: dst = leaky(mask(conv(leaky(src)))); else dst += mask(conv(src)).
// `w` is this conv's [CP][K][CP] weight block in global memory; `wst` the
// 2 * CB * K * CP float staging area in shared memory.
template <bool CONV1, int K>
__device__ __forceinline__ void conv_tile(const float* __restrict__ src, float* __restrict__ dst,
                                          const float* __restrict__ w, const float* __restrict__ bias,
                                          float* __restrict__ wst, int dil, int margin, const Cfg& cfg,
                                          int t0) {
  const int lane = threadIdx.x & 31;
  const int co0 = (threadIdx.x >> 5) * 8;
  const int CP = cfg.CP;
  const int pad = (K - 1) * dil / 2;
  const int lo = HALO - margin, hi = HALO + TT + margin;
  const int chunk = CB * K * CP;  // floats per staged chunk
  const int nchunk = CP / CB;
  float acc[8][8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float bc = bias[co0 + c];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][c] = bc;
  }
  stage(wst, w, chunk);
  for (int ch = 0; ch < nchunk; ++ch) {
    if (ch + 1 < nchunk) {
      stage(wst + ((ch + 1) & 1) * chunk, w + (ch + 1) * chunk, chunk);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk ch is in shared memory for every thread
    const float* wb = wst + (ch & 1) * chunk;
    for (int cc = 0; cc < CB; ++cc) {
      const float* srow = src + (ch * CB + cc) * LS + G + lane - pad;
      const float* wrow = wb + cc * K * CP + co0;
#pragma unroll
      for (int tap = 0; tap < K; ++tap) {
        const float4 wa = *reinterpret_cast<const float4*>(wrow + tap * CP);
        const float4 wc = *reinterpret_cast<const float4*>(wrow + tap * CP + 4);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wc.x, wc.y, wc.z, wc.w};
        const float* sp = srow + tap * dil;
        float xv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) xv[j] = CONV1 ? leaky(sp[32 * j], cfg.slope) : sp[32 * j];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[j][c] = fmaf(wv[c], xv[j], acc[j][c]);
      }
    }
    __syncthreads();  // every thread is done with this buffer before it is refilled
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int pos = lane + 32 * j;
    const int p = t0 - HALO + pos;
    const bool need = pos >= lo && pos < hi;
    const bool sig = p >= 0 && p < cfg.T;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float val = sig ? acc[j][c] : 0.f;
      float* d = dst + (co0 + c) * LS + G + pos;
      if (CONV1) *d = need ? leaky(val, cfg.slope) : 0.f;
      else if (need) *d += val;
    }
  }
}

// One residual unit: h = leaky(conv_{K,dil}(leaky(v))); v += conv_{K,1}(h).
template <int K>
__device__ void unit(float* v, float* h, const float* w1, const float* bias, float* wst, int dil,
                     int m1, int m2, const Cfg& cfg, int t0) {
  conv_tile<true, K>(v, h, w1, bias, wst, dil, m1, cfg, t0);
  __syncthreads();
  conv_tile<false, K>(h, v, w1 + cfg.CP * K * cfg.CP, bias + cfg.CP, wst, 1, m2, cfg, t0);
  __syncthreads();
}

__global__ void mrf_stage_kernel(const float* __restrict__ x, float* __restrict__ y,
                                 const float* __restrict__ w, const float* __restrict__ bias,
                                 const float* __restrict__ wp, const float* __restrict__ bp, Cfg cfg) {
  extern __shared__ __align__(16) float smem[];
  float* v = smem;                  // [CP][LS] residual stream
  float* h = v + cfg.CP * LS;       // [CP][LS] intermediate
  float* accs = h + cfg.CP * LS;    // [CP][AW] sum over resblocks
  float* wst = accs + cfg.CP * AW;  // [2][CB][kmax][CP] staged weights
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int nthr = blockDim.x, tid = threadIdx.x;
  const float* xb = x + (long long)b * cfg.C * cfg.T;

  for (int i = tid; i < 2 * cfg.CP * LS; i += nthr) smem[i] = 0.f;
  for (int i = tid; i < cfg.CP * AW; i += nthr) accs[i] = 0.f;
  const int pm = cfg.post_k > 0 ? (cfg.post_k - 1) / 2 : 0;

  const float* wr = w;
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
    __syncthreads();  // previous resblock's v fully consumed
    for (int i = tid; i < cfg.CP * L; i += nthr) {
      const int c = i / L, pos = i % L, p = t0 - HALO + pos;
      v[c * LS + G + pos] = (c < cfg.C && p >= 0 && p < cfg.T) ? xb[(long long)c * cfg.T + p] : 0.f;
    }
    __syncthreads();
    for (int u = 0; u < cfg.nunit; ++u) {
      const float* b1 = bias + ((r * cfg.nunit + u) * 2) * cfg.CP;
      const int d = cfg.dil[r][u];
      switch (k) {  // the host admits only these sizes
        case 3: unit<3>(v, h, wr, b1, wst, d, m1[u], m2[u], cfg, t0); break;
        case 7: unit<7>(v, h, wr, b1, wst, d, m1[u], m2[u], cfg, t0); break;
        case 11: unit<11>(v, h, wr, b1, wst, d, m1[u], m2[u], cfg, t0); break;
      }
      wr += 2 * cfg.CP * k * cfg.CP;
    }
    for (int i = tid; i < cfg.CP * AW; i += nthr) {
      const int c = i / AW, j = i % AW;
      accs[i] += v[c * LS + G + HALO - AM + j];
    }
  }
  __syncthreads();

  const float inv = 1.f / cfg.nres;
  if (cfg.post_k == 0) {
    for (int i = tid; i < cfg.C * TT; i += nthr) {
      const int c = i / TT, j = i % TT, p = t0 + j;
      if (p < cfg.T) y[((long long)b * cfg.C + c) * cfg.T + p] = accs[c * AW + AM + j] * inv;
    }
  } else {
    for (int j = tid; j < TT; j += nthr) {
      const int p = t0 + j;
      if (p >= cfg.T) continue;
      float s = bp[0];
      for (int c = 0; c < cfg.C; ++c) {
        const float* ar = accs + c * AW + AM + j - pm;
        for (int tap = 0; tap < cfg.post_k; ++tap)
          s = fmaf(wp[c * cfg.post_k + tap], leaky(ar[tap] * inv, 0.01f), s);
      }
      y[(long long)b * cfg.T + p] = tanhf(s);
    }
  }
}

}  // namespace

// x [B, C, T] fp32; y [B, C, T] (post_k == 0) or [B, 1, T]. w: for each
// resblock r and unit u, conv1 then conv2 weights packed [CP][k_r][CP]
// (ci, tap, co) with channels zero-padded to CP (a multiple of 8, <= 64);
// bias [nres][nunit][2][CP]; wp [C][post_k]; bp [1]. dils [nres * nunit].
// Kernel sizes must be 3, 7 or 11, the slope in [0, 1]. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unsupported geometry, without
// launching).
extern "C" int mrf_stage(const float* x, float* y, const float* w, const float* bias,
                         const float* wp, const float* bp, int B, int C, int CP, int T,
                         int nres, int nunit, const int* ks, const int* dils, float slope,
                         int post_k, void* stream) {
  if (nres < 1 || nres > MAXR || nunit < 1 || nunit > MAXU || CP % 8 || CP > 64 || C > CP ||
      post_k < 0 || (post_k > 0 && (post_k - 1) / 2 > AM) || !(slope >= 0.f && slope <= 1.f))
    return (int)cudaErrorInvalidValue;
  Cfg cfg;
  cfg.nres = nres;
  cfg.nunit = nunit;
  cfg.C = C;
  cfg.CP = CP;
  cfg.T = T;
  cfg.post_k = post_k;
  cfg.slope = slope;
  cfg.kmax = 0;
  for (int r = 0; r < nres; ++r) {
    if (ks[r] != 3 && ks[r] != 7 && ks[r] != 11) return (int)cudaErrorInvalidValue;
    cfg.ks[r] = ks[r];
    cfg.kmax = ks[r] > cfg.kmax ? ks[r] : cfg.kmax;
    int halo = post_k > 0 ? (post_k - 1) / 2 : 0;
    for (int u = 0; u < nunit; ++u) {
      cfg.dil[r][u] = dils[r * nunit + u];
      const int pad = (ks[r] - 1) * cfg.dil[r][u] / 2;
      if (pad > G) return (int)cudaErrorInvalidValue;
      halo += pad + (ks[r] - 1) / 2;
    }
    if (halo > HALO) return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)(2 * CP * LS + CP * AW + 2 * CB * cfg.kmax * CP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mrf_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + TT - 1) / TT, B);
  mrf_stage_kernel<<<grid, (CP / 8) * 32, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      x, y, w, bias, wp, bp, cfg);
  return (int)cudaGetLastError();
}
