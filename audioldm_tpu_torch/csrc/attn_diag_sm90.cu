// K7 of the attention diagnostic tool on the Hopper forward loop
// (flash_fwd_sm90.cuh `fwd_body`, the loop that K1 runs), bf16 only. It and
// K9 replace the Pallas TPU kernels of tools/bench_attn_diag.py:
//   K7  the kernel of `make_kernel` (:20), launched by `run` (:64), five
//       variants of one kv loop: full, exp2, no_max, no_exp, matmul_only;
//   K9  the inner kernel of `run_grid3` (:164), in attn_diag_grid3_sm90.cu.
// Each K7 variant is K1's loop with one kind of work taken out or changed
// (flash_fwd_sm90.cuh says what each computes a logit), so its time against
// K1's splits K1's. K8 and K10 run the same loop (attn_diag_k8_k10_sm90.cu).
//
// What bounds it: at [2, 8, 4096, 16] the exp variants do 268 M exp2 on
// the SFU (16 per SM per clock, 0.064 ms), against 17.2 GFLOP of products
// (0.017 ms at the bf16 tensor rate) and 8.4 MB of q/k/v/o (0.003 ms);
// no_exp and matmul_only have no exp2 and are bounded by the products.

#include <string.h>

#include "attn_diag_sm90.cuh"

using namespace fwd_sm90;

// kind: 0-4 the K7 variants full, exp2, no_max, no_exp, matmul_only (5-7,
// K8-K10, are attn_diag_k8_k10_sm90.cu's and attn_diag_grid3_sm90.cu's). q, k, v, o:
// bf16 [B, H, N, D] head views with 12 element strides (b, h, n) in
// `strides`, N % 64 == 0, D % 8 == 0, D <= 128. scale: 1/sqrt(d) (q loads
// unscaled). block_k: exp2's max granularity, a multiple of 64 dividing N
// (ignored by the others). Returns a cudaError_t: the tensor maps'
// encoding, then cudaGetLastError() after the launch.
extern "C" int attn_diag_sm90(int kind, const void* q, const void* k, const void* v, void* o, int B, int H, int N, int D,
                              const long long* strides, float scale, int block_k, void* stream) {
  if (N < BN || N % BN || D < 8 || D % 8 || D > 128 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (kind == 1 && (block_k < BN || block_k % BN || N % block_k)) return (int)cudaErrorInvalidValue;
  Strides s;
  memcpy(&s, strides, sizeof(s));
  CUtensorMap tk, tv;
  const int err = maps(&tk, &tv, k, v, B, H, N, D, s);
  if (err) return err;
  auto* qq = static_cast<const __nv_bfloat16*>(q);
  auto* oo = static_cast<__nv_bfloat16*>(o);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return dispatch<Fwd::FULL, 2>(tk, tv, qq, oo, B, H, N, D, s, 1.f, scale, 1, st);
    case 1:
      if (block_k == BN) return dispatch<Fwd::EXP2, 2>(tk, tv, qq, oo, B, H, N, D, s, 1.f, scale, 1, st);
      return dispatch<Fwd::EXP2_BLOCKS, 2>(tk, tv, qq, oo, B, H, N, D, s, 1.f, scale, block_k / BN, st);
    case 2: return dispatch<Fwd::NO_MAX, 2>(tk, tv, qq, oo, B, H, N, D, s, 1.f, scale, 1, st);
    case 3: return dispatch<Fwd::NO_EXP, 2>(tk, tv, qq, oo, B, H, N, D, s, 1.f, scale, 1, st);
    case 4: return dispatch<Fwd::MATMUL_ONLY, 2>(tk, tv, qq, oo, B, H, N, D, s, 1.f, scale, 1, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
