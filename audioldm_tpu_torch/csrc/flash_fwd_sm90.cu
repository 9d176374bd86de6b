// K1, K6 and K3 in bf16: the flash-attention forward, non-causal, unmasked,
// written for Hopper (sm_90a) with wgmma, a TMA ring and 128-row q tiles;
// K1 and K6 for inference, K3 for training with the logsumexp output that
// the backward kernels (flash_bwd_sm90.cu) recompute the softmax from.
//
// K1 replaces the Pallas TPU kernel `_flash_kernel_nolse`
// (audioldm_tpu/kernels/flash_attention.py:128), K6 `_flash_kernel_one`
// (:133, selected at :197-199 when the kv axis is one block and `_ONE_PASS`
// is on), K3 `_flash_kernel` (:86, launched by `_flash_bh` from
// `_flash_vjp_fwd`). All compute the TPU kernels' function with their arithmetic:
// q2 = bf16(q * log2(e)/sqrt(d)) (the JAX wrapper's `_pad_reshape`, :387;
// here rounded as q loads), s2 = q2 k^T in fp32, softmax in base 2, P
// rounded to bf16 for P V, fp32 accumulation.
//   K1: running max, sum and accumulator (fp32); the accumulator and sum are
//       rescaled only when a row's max grows; l sums the fp32 P.
//   K3: K1 (template flag LSE), and each consumer warpgroup stores
//       lse2 = m + log2(l) of its rows into a contiguous fp32 [B, H, N]
//       buffer (4 bytes a row; the TPU kernel broadcasts it over 128 lanes).
//       It is handed q2 already rounded (scale_log2 = 1: rounding it again
//       changes nothing), which the backward kernels take too.
//   K6: two sweeps over K. Sweep 1 takes the exact max m of every whole
//       row (S = q2 k^T only, no exp2, no P V); sweep 2 computes
//       P = bf16(exp2(s2 - m)) and P V with no rescale, and l is the fp32
//       sum of the ROUNDED P: the P V product is 8 columns wider,
//       [O | l] = P [V | 1], its B operand's second column block a block of
//       bf16 ones in shared memory (the ones column that the TPU wrapper
//       writes into V's padding; here no byte of V moves for it). At d > 64
//       V already spans two column blocks, and l is a product of its own,
//       m64n8k16 of P against the ones (at every d that costs one more wgmma
//       per 16 kv rows: variant `ones_product` of
//       audioldm_tpu_torch/tools/flash_sm90_variants.py).
//
// What bounds them on an H100: at the UNet's level-0 shape [2, 8, 4096, 16]
// one exp2 per logit, 268 M on the SFU (16 a clock an SM): 0.064 ms. The
// products are 17.2 GFLOP (0.017 ms at the bf16 tensor rate), q, k, v, o
// 8.4 MB (0.003 ms at HBM rate). The previous design (flash_attention.cu,
// 64-row q tiles, mma.sync, K fragments read from shared memory with 32-bit
// loads, V with ldmatrix.trans, a 2-stage cp.async ring) took 0.155 ms on
// an H100 80GB HBM3 at 700 W, and with the exp2 removed still 0.11 ms
// (tools/bench_attn_diag.py's matmul_only): products issued as 16x8
// pieces, fragment loads, and L2
// re-reads of K and V by every 64-row q tile. This design:
//   - a CTA takes 128 q rows: two consumer warpgroups of 64 rows and one
//     producer warp, so each K and V tile read from L2 serves 128 rows (the
//     L2 traffic halves: 134 MB a call at the main shape);
//   - both products are wgmma.mma_async: S = q2 K^T (m64n64k16 for each 16
//     of d; A = q2 in registers, B = the K tile, K-major as it lies) and
//     O += P V (m64nDk16 for each 16 kv rows; A = P in registers, packed
//     straight from S's accumulators, whose layout is the A fragment's; B =
//     the V tile read MN-major, imm-trans-b). No K or V fragment is loaded
//     by the threads;
//   - K and V tiles of 64 rows arrive by TMA (cp.async.bulk.tensor, 4-D
//     maps (d, h, n, b) over the head views, swizzled to the row width:
//     32 B at d <= 16, 64 B at d <= 32, 128 B above, two 64-column boxes at
//     d > 64) into a ring of 4 stages (3 at d > 64) with full and empty
//     mbarriers. TMA zero-fills kv rows past M and columns past D; the
//     ragged last tile is still masked to -inf;
//   - within a warpgroup, S of tile t is issued together with P V of tile
//     t-1, and the softmax of tile t runs while P V still does; P lives in
//     two register sets that take turns, so nothing redefines the A
//     operand of a product in flight (ptxas serializes the wgmma pipeline
//     when something does, C7513). The two warpgroups, and the two CTAs an
//     SM at d <= 32, run their softmaxes under each other's products
//     without being made to take turns (forcing turns with named barriers,
//     FlashAttention-3's ping-pong, measured slower at d = 16: variant
//     `pingpong` of the tool above);
//   - K6's sweep 1 keeps two S register sets in turn too: S of tile t+1
//     runs while the max of tile t is taken;
//   - q is pre-scaled and rounded as it loads: no multiply a logit; P is
//     packed with one cvt.rn.bf16x2.f32 a pair; the rescale is skipped
//     when no row of a warp grew its max.
// The loop itself is `fwd_body` in flash_fwd_sm90.cuh, which the diagnostic
// kernels K7 and K9 (attn_diag_sm90.cu) run too; this file holds K1's, K6's
// and K3's kernel instances and their C entries.
// Grid: ceil(N / 128) x (B * H); 288 threads (nine warps). At d <= 32 the
// registers are sized for two CTAs an SM, which caps a thread at 96 (five
// of the 18 warps share one SM sub-partition's 16384 registers): at
// [2, 8, 4096, 16] 512 CTAs are 1.94 waves of 264, at batch 1 256 CTAs one
// wave (0.97).
//
// Requires D % 8 == 0, D <= 128, 16-byte aligned q/k/v/o and (b, h, n)
// strides that are multiples of 8 elements (the wrapper pads and copies to
// get them).

#include <string.h>

#include "flash_fwd_sm90.cuh"

namespace {

using namespace fwd_sm90;

constexpr int NTHREADS = Team<2>::NTHREADS;  // two consumer warpgroups and one producer warp

template <int DP, bool ONE, bool LSE>
__global__ void __launch_bounds__(NTHREADS, Cfg<DP>::MINB) flash_fwd_sm90_kernel(
    const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv,
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int N, int M,
    int D, Strides s, float scale_log2) {
  static_assert(!(ONE && LSE), "K3 is the streaming forward");
  fwd_body<DP, ONE ? Fwd::K6 : LSE ? Fwd::K3 : Fwd::K1, 2>(tmk, tmv, q, o, lse, H, N, M, D, s, scale_log2, 1.f, 1);
}

template <int DP, bool ONE, bool LSE>
int launch(const CUtensorMap& tk, const CUtensorMap& tv, const __nv_bfloat16* q, __nv_bfloat16* o, float* lse, int B,
           int H, int N, int M, int D, const Strides& s, float scale_log2, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(flash_fwd_sm90_kernel<DP, ONE, LSE>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<DP>::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((N + Team<2>::BM - 1) / Team<2>::BM, B * H);
  flash_fwd_sm90_kernel<DP, ONE, LSE><<<grid, NTHREADS, Cfg<DP>::SMEM, st>>>(tk, tv, q, o, lse, H, N, M, D, s,
                                                                             scale_log2);
  return (int)cudaGetLastError();
}

template <bool ONE, bool LSE>
int dispatch(const CUtensorMap& tk, const CUtensorMap& tv, const __nv_bfloat16* q, __nv_bfloat16* o, float* lse,
             int B, int H, int N, int M, int D, const Strides& s, float scale_log2, cudaStream_t st) {
  if (D <= 16) return launch<16, ONE, LSE>(tk, tv, q, o, lse, B, H, N, M, D, s, scale_log2, st);
  if (D <= 32) return launch<32, ONE, LSE>(tk, tv, q, o, lse, B, H, N, M, D, s, scale_log2, st);
  if (D <= 64) return launch<64, ONE, LSE>(tk, tv, q, o, lse, B, H, N, M, D, s, scale_log2, st);
  return launch<128, ONE, LSE>(tk, tv, q, o, lse, B, H, N, M, D, s, scale_log2, st);
}

// K1 (mode 0), K6 (mode 1) or K3 (mode 2, lse2 into `lse`) on bf16 tensors
int run(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int N, int M, int D,
        const long long* strides, float scale_log2, int mode, void* stream) {
  if (D < 8 || D > 128 || D % 8 || M < 1) return (int)cudaErrorInvalidValue;
  Strides s;
  memcpy(&s, strides, sizeof(s));
  CUtensorMap tk, tv;
  const int err = maps(&tk, &tv, k, v, B, H, M, D, s);
  if (err) return err;
  auto* qq = static_cast<const __nv_bfloat16*>(q);
  auto* oo = static_cast<__nv_bfloat16*>(o);
  auto* ll = static_cast<float*>(lse);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (mode == 1) return dispatch<true, false>(tk, tv, qq, oo, ll, B, H, N, M, D, s, scale_log2, st);
  if (mode == 2) return dispatch<false, true>(tk, tv, qq, oo, ll, B, H, N, M, D, s, scale_log2, st);
  return dispatch<false, false>(tk, tv, qq, oo, ll, B, H, N, M, D, s, scale_log2, st);
}

}  // namespace

// K1 (one = 0) or K6 (one = 1) on bf16 tensors. strides: 12 element strides
// (b, h, n) of q, k, v, o. Returns a cudaError_t: the tensor maps' encoding,
// then cudaGetLastError() after the launch.
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int M, int D,
                              const long long* strides, float scale_log2, int one, void* stream) {
  return run(q, k, v, o, nullptr, B, H, N, M, D, strides, scale_log2, one ? 1 : 0, stream);
}

// K3 on bf16 tensors: as K1, and writes lse2 = m + log2(l) into the
// contiguous fp32 [B, H, N] buffer `lse`. q is the pre-scaled q2 (with
// scale_log2 = 1).
extern "C" int flash_fwd_sm90_lse(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int N,
                                  int M, int D, const long long* strides, float scale_log2, void* stream) {
  return run(q, k, v, o, lse, B, H, N, M, D, strides, scale_log2, 2, stream);
}

// Encodes the two tensor maps of a call `iters` times and launches nothing:
// the host cost of the encoding alone, for the wrapper's timing.
extern "C" int flash_fwd_sm90_encode(const void* k, const void* v, int B, int H, int M, int D, const long long* strides,
                                     int iters) {
  Strides s;
  memcpy(&s, strides, sizeof(s));
  CUtensorMap tk, tv;
  for (int i = 0; i < iters; ++i) {
    const int err = maps(&tk, &tv, k, v, B, H, M, D, s);
    if (err) return err;
  }
  return 0;
}
