// K7-K10 in fp32: the attention bench tool's diagnostic kernels on fp32
// inputs, on the fp32 K1's loop (flash_fwd_f32.cuh: 3xTF32 on wgmma, TMA,
// transform warps), as the bf16 ones run the bf16 K1's (attn_diag_sm90.cu,
// attn_diag_grid3_sm90.cu, attn_diag_k8_k10_sm90.cu).
//
// They replace the Pallas TPU kernels of tools/bench_attn_diag.py when the
// tool hands them fp32: K7, the kernel of `make_kernel` (:20) that `run`
// (:64) launches in five variants (full, exp2, no_max, no_exp, matmul_only);
// K8 of `run_fori_exp2` (:112); K9 of `run_grid3` (:164); K10 of
// `run_grid3b` (:259). One instance per kind and head dim, 32, each
// computing its plain version in kernels/attn_diag.py (`diag_loop_plain`,
// `flash_exp2_plain`) in fp32; the header says what each computes a logit:
//   - K7 takes s = (q . k) * scale (matmul_only: unscaled, l = 0); full
//     takes a running max from -inf and rescales by alpha = exp(m - m_new)
//     (0 while m is -inf); exp2 commits the max once every block_k kv rows
//     and never rescales, so its result depends on block_k; no_max p =
//     exp(s); no_exp p = s; out = acc / max(l, 1e-20).
//   - K8, K9, K10 take q2 = q * scale (scale = log2(e)/sqrt(d), one fp32
//     rounding), s = q2 . k, the running max from -1e30, p = exp2(s - m),
//     alpha = exp2(m - m_new), out = acc / l. K8 runs in a ring of 2 stages,
//     K9 in the full ring; K10 takes l from ones in P V. Rounding P to v's
//     dtype does nothing in fp32, so the three compute one function.
// Full and K8-K10 take their max a kv tile at a time, whatever block_k:
// that changes fp32 rounding only (the running max rescales what came
// before). exp2's block_k must be a whole number of the loop's tiles (64 kv
// rows at d <= 16, 32 above); the wrapper refuses other values before launch.
//
// What bounds it on an H100: at [2, 8, 4096, 16] 17.2 GFLOP of products,
// 0.104 ms as three TF32 tensor-core products (0.256 ms of fp32 FMA, which
// the first design, SIMT, could not beat: 0.64-1.09 ms), against 268 M
// exponentials (0.064 ms) and 16.8 MB of q/k/v/o; exp2 over blocks wider
// than a tile issues S's products twice.

#include "flash_fwd_f32.cuh"

using fwd_f32::F32;
using fwd_f32::launch;

namespace {

// the kinds, numbered as kernels/attn_diag.py `_KIND`
constexpr F32 KIND[] = {F32::FULL, F32::EXP2, F32::NO_MAX, F32::NO_EXP, F32::MATMUL_ONLY, F32::K8, F32::K9, F32::K10};

template <F32 V>
int run(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int D, const long long* strides,
        float scale, int block_k, void* stream) {
  constexpr bool K7 = fwd_f32::Var<V>::K7;  // the K7 kinds scale the logit; K8-K10 q as it loads
  return launch<V>(q, k, v, o, nullptr, B, H, N, N, D, strides, K7 ? 1.f : scale, K7 ? scale : 1.f, block_k, stream);
}

}  // namespace

// K7-K10 in fp32. kind: as `_KIND` (0-4 the K7 variants, 5 K8, 6 K9, 7
// K10); strides: 12 element strides (b, h, n) of q, k, v, o, multiples of
// 8, each with a unit stride along d; D % 8 == 0, D <= 128; scale:
// 1/sqrt(d) for K7, log2(e)/sqrt(d) for K8-K10; block_k: the kv rows a
// committed max covers, read by exp2 (a multiple of 64 at D <= 16, of 32
// above, that divides N). Returns a cudaError_t: the tensor maps' encoding,
// then cudaGetLastError() after the launch.
extern "C" int attn_diag_f32(int kind, const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                             int D, const long long* strides, float scale, int block_k, void* stream) {
  if (kind < 0 || kind >= (int)(sizeof(KIND) / sizeof(KIND[0]))) return (int)cudaErrorInvalidValue;
  switch (KIND[kind]) {
    case F32::FULL: return run<F32::FULL>(q, k, v, o, B, H, N, D, strides, scale, block_k, stream);
    case F32::EXP2: return run<F32::EXP2>(q, k, v, o, B, H, N, D, strides, scale, block_k, stream);
    case F32::NO_MAX: return run<F32::NO_MAX>(q, k, v, o, B, H, N, D, strides, scale, block_k, stream);
    case F32::NO_EXP: return run<F32::NO_EXP>(q, k, v, o, B, H, N, D, strides, scale, block_k, stream);
    case F32::MATMUL_ONLY: return run<F32::MATMUL_ONLY>(q, k, v, o, B, H, N, D, strides, scale, block_k, stream);
    case F32::K8: return run<F32::K8>(q, k, v, o, B, H, N, D, strides, scale, block_k, stream);
    case F32::K9: return run<F32::K9>(q, k, v, o, B, H, N, D, strides, scale, block_k, stream);
    default: return run<F32::K10>(q, k, v, o, B, H, N, D, strides, scale, block_k, stream);
  }
}
