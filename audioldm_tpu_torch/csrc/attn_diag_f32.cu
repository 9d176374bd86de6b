// K7-K10 in fp32: the attention bench tool's diagnostic kernels on fp32
// inputs. In bf16 they run K1's Hopper loop (attn_diag_sm90.cu,
// attn_diag_grid3_sm90.cu, attn_diag_k8_k10_sm90.cu); wgmma takes no fp32
// operands, so here every product is a plain fp32 FMA.
//
// They replace the Pallas TPU kernels of tools/bench_attn_diag.py when the
// tool hands them fp32: K7, the kernel of `make_kernel` (:20) that `run`
// (:64) launches in five variants (full, exp2, no_max, no_exp, matmul_only);
// K8 of `run_fori_exp2` (:112); K9 of `run_grid3` (:164); K10 of
// `run_grid3b` (:259). One __global__ template, one instance per kind and
// head dim, each computing its plain version in kernels/attn_diag.py
// (`diag_loop_plain`, `flash_exp2_plain`) in fp32:
//   - K7 takes s = (q . k) * scale (matmul_only: unscaled, l = 0); full
//     commits a running max from -inf once every block_k kv rows and
//     rescales by alpha = exp(m - m_new) (0 while m is -inf); exp2 commits
//     the max once a block and never rescales, so its result depends on
//     block_k; no_max p = exp(s); no_exp p = s; out = acc / max(l, 1e-20).
//   - K8, K9, K10 take q2 = q * scale (scale = log2(e)/sqrt(d), one fp32
//     rounding), s = q2 . k, the running max from -1e30 once a block_k
//     block, p = exp2(s - m), alpha = exp2(m - m_new), out = acc / l.
//     Rounding P to v's dtype does nothing in fp32, so K10's ones column is
//     K9's sum and the three compute one function; they stay three
//     instances under three names, as their launches are three counters.
//
// Each kind that commits a max per block needs the block's max before the
// block's weights, and a block can be the whole kv axis (exp2 at block_k =
// N = 4096: 256 KB of K and V at d = 16). So such a block is swept twice
// through shared memory: first its K tiles for the max, then its K and V
// tiles for the weights and the sums. block_k must be a whole number of the
// 32-row tiles (the wrapper refuses other values before launch).
//
// What bounds it on an H100: at [2, 8, 4096, 16] 17.2 GFLOP of fp32 FMA
// (0.256 ms at 67 TFLOP/s; the second sweep of full, exp2 and K8-K10 adds
// half again) against 268 M exponentials and 16.8 MB of q/k/v/o. The design
// is the fp32 K1's first one, which the fp32 K6 (flash_attention_one.cu)
// keeps (the fp32 K1 and K3 now run 3xTF32 on wgmma, flash_attention.cu):
// one thread a q row with q and the accumulator in registers (d = 128
// spills), 32-row K/V tiles in shared memory read by every thread at one
// address (a broadcast), plain fp32 FMA in the order of the kv rows.

#include <math.h>
#include <string.h>

#include <cuda_runtime.h>

namespace {

struct Strides {
  long long qb, qh, qn, kb, kh, kn, vb, vh, vn, ob, oh, on;
};

// the kinds, numbered as kernels/attn_diag.py `_KIND`
enum Kind : int { FULL = 0, EXP2 = 1, NO_MAX = 2, NO_EXP = 3, MATMUL_ONLY = 4, K8 = 5, K9 = 6, K10 = 7 };

constexpr int TN = 32;     // kv rows of a shared-memory tile
constexpr int ROWS = 128;  // q rows (threads) a CTA
constexpr float LOG2E = 1.4426950408889634f;

template <int KIND>
__device__ constexpr bool commits_max() {
  return KIND == FULL || KIND == EXP2 || KIND >= K8;
}

// Copy kv rows [kv0, kv0 + rows) of K (and of V with `with_v`) into the
// tiles, zeros beyond the row count and the head dim.
template <int DM>
__device__ void load_tile(float (*ks)[DM], float (*vs)[DM], const float* kp, const float* vp, const Strides& s,
                          int kv0, int rows, int D, bool with_v) {
  for (int idx = threadIdx.x; idx < TN * DM; idx += ROWS) {
    const int r = idx / DM, c = idx % DM;
    const bool ok = r < rows && c < D;
    ks[r][c] = ok ? kp[(long long)(kv0 + r) * s.kn + c] : 0.f;
    if (with_v) vs[r][c] = ok ? vp[(long long)(kv0 + r) * s.vn + c] : 0.f;
  }
}

// The logit of one kv row: q . k, times `scale` for K7 (but matmul_only);
// K8-K10 hold q already scaled.
template <int DM, int KIND>
__device__ __forceinline__ float logit(const float (&qr)[DM], const float* kr, float scale) {
  float sc = 0.f;
#pragma unroll
  for (int d = 0; d < DM; ++d) sc = fmaf(qr[d], kr[d], sc);
  return (KIND <= NO_EXP) ? sc * scale : sc;
}

template <int DM, int KIND>
__global__ void __launch_bounds__(ROWS) attn_diag_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                                             const float* __restrict__ v, float* __restrict__ o, int H,
                                                             int N, int D, Strides s, float scale, int block_k) {
  __shared__ float ks[TN][DM];
  __shared__ float vs[TN][DM];
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int row = blockIdx.x * ROWS + threadIdx.x;
  const float* kp = k + b * s.kb + h * s.kh;
  const float* vp = v + b * s.vb + h * s.vh;

  float qr[DM], acc[DM];
  const float* qrow = q + b * s.qb + h * s.qh + (long long)min(row, N - 1) * s.qn;
  const float qscale = KIND >= K8 ? scale : 1.f;
#pragma unroll
  for (int d = 0; d < DM; ++d) {
    qr[d] = (row < N && d < D) ? qrow[d] * qscale : 0.f;
    acc[d] = 0.f;
  }
  float m = KIND >= K8 ? -1e30f : -INFINITY, l = 0.f;
  const int bk = commits_max<KIND>() ? block_k : N;  // the kinds without a max run the kv axis as one block
  for (int b0 = 0; b0 < N; b0 += bk) {
    const int b1 = min(N, b0 + bk);
    float m_new = m;
    if (commits_max<KIND>()) {  // first sweep: the block's max
      float bmax = -INFINITY;
      for (int kv0 = b0; kv0 < b1; kv0 += TN) {
        const int rows = min(TN, b1 - kv0);
        __syncthreads();
        load_tile<DM>(ks, vs, kp, vp, s, kv0, rows, D, false);
        __syncthreads();
        for (int j = 0; j < rows; ++j) bmax = fmaxf(bmax, logit<DM, KIND>(qr, ks[j], scale));
      }
      m_new = fmaxf(m, bmax);
      if (KIND == FULL || KIND >= K8) {
        const float alpha = KIND >= K8 ? exp2f(m - m_new) : (isinf(m) ? 0.f : expf(m - m_new));
        l *= alpha;
#pragma unroll
        for (int d = 0; d < DM; ++d) acc[d] *= alpha;
      }
    }
    for (int kv0 = b0; kv0 < b1; kv0 += TN) {  // the block's weights, sums and products
      const int rows = min(TN, b1 - kv0);
      __syncthreads();
      load_tile<DM>(ks, vs, kp, vp, s, kv0, rows, D, true);
      __syncthreads();
      for (int j = 0; j < rows; ++j) {
        const float sc = logit<DM, KIND>(qr, ks[j], scale);
        float p;
        if (KIND == FULL) p = expf(sc - m_new);
        else if (KIND == EXP2) p = exp2f((sc - m_new) * LOG2E);
        else if (KIND == NO_MAX) p = expf(sc);
        else if (KIND == NO_EXP || KIND == MATMUL_ONLY) p = sc;
        else p = exp2f(sc - m_new);
        if (KIND != MATMUL_ONLY) l += p;
#pragma unroll
        for (int d = 0; d < DM; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
      }
    }
    m = m_new;
  }
  if (row < N) {
    float* orow = o + b * s.ob + h * s.oh + (long long)row * s.on;
    const float den = KIND >= K8 ? l : fmaxf(l, 1e-20f);
    for (int d = 0; d < D; ++d) orow[d] = acc[d] / den;
  }
}

template <int DM, int KIND>
int launch(const float* q, const float* k, const float* v, float* o, int B, int H, int N, int D, const Strides& s,
           float scale, int block_k, cudaStream_t st) {
  const dim3 grid((N + ROWS - 1) / ROWS, B * H);
  attn_diag_f32_kernel<DM, KIND><<<grid, ROWS, 0, st>>>(q, k, v, o, H, N, D, s, scale, block_k);
  return (int)cudaGetLastError();
}

template <int DM>
int dispatch_kind(int kind, const float* q, const float* k, const float* v, float* o, int B, int H, int N, int D,
                  const Strides& s, float scale, int block_k, cudaStream_t st) {
  switch (kind) {
    case FULL: return launch<DM, FULL>(q, k, v, o, B, H, N, D, s, scale, block_k, st);
    case EXP2: return launch<DM, EXP2>(q, k, v, o, B, H, N, D, s, scale, block_k, st);
    case NO_MAX: return launch<DM, NO_MAX>(q, k, v, o, B, H, N, D, s, scale, block_k, st);
    case NO_EXP: return launch<DM, NO_EXP>(q, k, v, o, B, H, N, D, s, scale, block_k, st);
    case MATMUL_ONLY: return launch<DM, MATMUL_ONLY>(q, k, v, o, B, H, N, D, s, scale, block_k, st);
    case K8: return launch<DM, K8>(q, k, v, o, B, H, N, D, s, scale, block_k, st);
    case K9: return launch<DM, K9>(q, k, v, o, B, H, N, D, s, scale, block_k, st);
    case K10: return launch<DM, K10>(q, k, v, o, B, H, N, D, s, scale, block_k, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K7-K10 in fp32. kind: as `_KIND` (0-4 the K7 variants, 5 K8, 6 K9, 7
// K10); strides: 12 element strides (b, h, n) of q, k, v, o, each with a
// unit stride along d; scale: 1/sqrt(d) for K7, log2(e)/sqrt(d) for K8-K10;
// block_k: the kv rows a committed max covers, a multiple of 32 (read by
// full, exp2 and K8-K10). Returns cudaGetLastError() after launch.
extern "C" int attn_diag_f32(int kind, const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                             int D, const long long* strides, float scale, int block_k, void* stream) {
  Strides s;
  memcpy(&s, strides, sizeof(s));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto* qq = static_cast<const float*>(q);
  auto* kk = static_cast<const float*>(k);
  auto* vv = static_cast<const float*>(v);
  auto* oo = static_cast<float*>(o);
  if (D <= 16) return dispatch_kind<16>(kind, qq, kk, vv, oo, B, H, N, D, s, scale, block_k, st);
  if (D <= 32) return dispatch_kind<32>(kind, qq, kk, vv, oo, B, H, N, D, s, scale, block_k, st);
  if (D <= 64) return dispatch_kind<64>(kind, qq, kk, vv, oo, B, H, N, D, s, scale, block_k, st);
  return dispatch_kind<128>(kind, qq, kk, vv, oo, B, H, N, D, s, scale, block_k, st);
}
