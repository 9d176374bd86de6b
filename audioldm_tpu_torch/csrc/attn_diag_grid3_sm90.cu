// K9 of the attention diagnostic tool, the inner kernel of `run_grid3`
// (tools/bench_attn_diag.py:164), on the Hopper forward loop
// (flash_fwd_sm90.cuh `fwd_body`, the loop that K1 runs), bf16 only: K1's
// function with the tool's arithmetic, q pre-scaled by log2(e)/sqrt(d) and
// rounded as it loads, p = exp2(s - m), the running max from -1e30 (the
// JAX tool's value), out = acc / l. K9 against K1 reads the same within
// noise. At small grids it runs a one-warpgroup instance, 64 q rows and 160
// threads a CTA, sized for twice as many CTAs an SM, which doubles the
// grid: the wrapper picks it when the grid of 128-row tiles is under one
// wave (kernels/attn_diag.py `q_rows`). A source of its own beside K7's
// attn_diag_sm90.cu, so that nvcc builds the two at once.
//
// What bounds it: at [2, 8, 4096, 16] 268 M exp2 on the SFU (0.064 ms),
// against 17.2 GFLOP of products (0.017 ms) and 8.4 MB of q/k/v/o
// (0.003 ms); at [2, 8, 512, 64] 4.2 MB of q/k/v/o (0.0013 ms).

#include <string.h>

#include "attn_diag_sm90.cuh"

using namespace fwd_sm90;

// q, k, v, o: bf16 [B, H, N, D] head views with 12 element strides (b, h, n)
// in `strides`, N % 64 == 0, D % 8 == 0, D <= 128. scale: log2(e)/sqrt(d).
// rows: q rows a CTA, 128 (two consumer warpgroups) or 64 (one). Returns a
// cudaError_t: the tensor maps' encoding, then cudaGetLastError() after the
// launch.
extern "C" int attn_diag_grid3_sm90(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int D,
                                    const long long* strides, float scale, int rows, void* stream) {
  if (N < BN || N % BN || D < 8 || D % 8 || D > 128 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (rows != 64 && rows != 128) return (int)cudaErrorInvalidValue;
  Strides s;
  memcpy(&s, strides, sizeof(s));
  CUtensorMap tk, tv;
  const int err = maps(&tk, &tv, k, v, B, H, N, D, s);
  if (err) return err;
  auto* qq = static_cast<const __nv_bfloat16*>(q);
  auto* oo = static_cast<__nv_bfloat16*>(o);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (rows == 64) return dispatch<Fwd::K9, 1>(tk, tv, qq, oo, B, H, N, D, s, scale, 1.f, 1, st);
  return dispatch<Fwd::K9, 2>(tk, tv, qq, oo, B, H, N, D, s, scale, 1.f, 1, st);
}
