// K8 and K10 of the attention diagnostic tool on the Hopper forward loop
// (flash_fwd_sm90.cuh `fwd_body`, the loop that K1 runs), bf16 only, 128 q
// rows a CTA in two consumer warpgroups. They replace the Pallas TPU kernels
// of tools/bench_attn_diag.py:
//   K8   the inner kernel of `run_fori_exp2` (:124): K9's function (q
//        pre-scaled by log2(e)/sqrt(d) and rounded as it loads, the running
//        max from -1e30, p = exp2(s - m), the rescale by exp2(m - m_new), l
//        the fp32 sum of p, out = acc / l) with the kv tiles in a ring of 2
//        stages instead of K9's 4 (3 at d = 128): the TPU kernel loads no kv
//        tile ahead, and 2 is the shallowest ring the loop runs
//        (flash_fwd_sm90.cuh, Var::RING says why K and V cannot stay
//        resident). K8 against K9 reads what the deeper ring buys;
//   K10  the inner kernel of `run_grid3b` (:274): K9 with l from a ones
//        column of V, so l is the sum of the ROUNDED p and the same alpha
//        rescales it. No byte of V moves for it: the P V product takes 8
//        more columns from a block of bf16 ones in shared memory at d <= 64
//        (n 24 at d = 16), and at d = 72-120 (padded to 128) a m64n8k16 of P
//        against the ones. Its accumulators are rescaled with the output's.
// A source of its own beside K7's and K9's, so that nvcc builds the three at
// once.
//
// What bounds them: at [2, 8, 4096, 16] 268 M exp2 on the SFU (0.064 ms),
// against 17.2 GFLOP of products (0.017 ms) and 8.4 MB of q/k/v/o
// (0.003 ms).

#include <string.h>

#include "attn_diag_sm90.cuh"

using namespace fwd_sm90;

// kind: 5 K8, 7 K10 (0-4 and 6, K7 and K9, are attn_diag_sm90.cu's and
// attn_diag_grid3_sm90.cu's). q, k, v, o: bf16 [B, H, N, D] head views with
// 12 element strides (b, h, n) in `strides`, N % 64 == 0, D % 8 == 0,
// D <= 128 (K10: D < 128, its ones lane lives in the TPU's head-dim
// padding). scale: log2(e)/sqrt(d). Returns a cudaError_t: the tensor maps'
// encoding, then cudaGetLastError() after the launch.
extern "C" int attn_diag_k8_k10_sm90(int kind, const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                                     int D, const long long* strides, float scale, void* stream) {
  if (N < BN || N % BN || D < 8 || D % 8 || D > 128 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (kind != 5 && kind != 7) return (int)cudaErrorInvalidValue;
  if (kind == 7 && D == 128) return (int)cudaErrorInvalidValue;
  Strides s;
  memcpy(&s, strides, sizeof(s));
  CUtensorMap tk, tv;
  const int err = maps(&tk, &tv, k, v, B, H, N, D, s);
  if (err) return err;
  auto* qq = static_cast<const __nv_bfloat16*>(q);
  auto* oo = static_cast<__nv_bfloat16*>(o);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (kind == 5) return dispatch<Fwd::K8, 2>(tk, tv, qq, oo, B, H, N, D, s, scale, 1.f, 1, st);
  return dispatch<Fwd::K10, 2>(tk, tv, qq, oo, B, H, N, D, s, scale, 1.f, 1, st);
}
