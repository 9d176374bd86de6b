// K1, K3 and K6 in fp32: flash-attention forward, non-causal, unmasked; K3
// with the logsumexp output that the backward kernels
// (flash_attention_bwd.cu) recompute the softmax from, K1 without, K6 the
// one-pass variant for a single kv block. In bf16 the three are
// flash_fwd_sm90.cu.
//
// K1 replaces the Pallas TPU kernel `_flash_kernel_nolse`
// (audioldm_tpu/kernels/flash_attention.py:128, launched by
// `_flash_bh(with_lse=False)` from `_flash_fwd_impl`); K3 replaces
// `_flash_kernel` (:86, launched by `_flash_bh` from `_flash_vjp_fwd`); K6
// replaces `_flash_kernel_one` (:133, selected by `_flash_bh` when the whole
// kv axis is one block, no lse is wanted and `_ONE_PASS` is on). All three
// are flash_fwd_f32.cuh's body (3xTF32 on wgmma, TMA, transform warps; the
// header sets out the design and what bounds it on an H100):
//   K1  s2 = (q * scale_log2) k^T in fp32, an online base-2 softmax (kv
//       columns past M masked before the max), out = (P v) / l with l the
//       fp32 sum of P;
//   K3  K1 with one store more per q row: lse2 = m + log2(l), the base-2
//       logsumexp of the scaled logits, into a contiguous fp32 [B, H, N]
//       buffer (the TPU kernel broadcasts it over 128 lanes; here it is 4
//       bytes a row). K3 is handed q2 = q * log2(e)/sqrt(d) with scale_log2
//       = 1 (fp32 q2 is the same product as the kernel's own);
//   K6  the function of K1 in two sweeps: the max m of every whole row
//       first, then P = exp2(s2 - m) with no running max and no rescale, l
//       the fp32 sum of P (what a column of ones appended to V gives: P
//       rounds to itself in fp32).
//
// O = softmax(Q K^T / sqrt(d)) V over [B, H, N, D] with (b, h, n) strides
// that are multiples of 8 elements, a unit stride along d, 16-byte aligned
// bases and D % 8 == 0, D <= 128 (the wrapper pads and copies to get them),
// so the UNet's q/k/v views of the projection outputs and the merged-heads
// output need no copies.

#include "flash_fwd_f32.cuh"

using fwd_f32::F32;
using fwd_f32::launch;

// K1 in fp32 (bf16 K1 is flash_fwd_sm90). strides: 12 element strides
// (b, h, n) of q, k, v, o. Returns a cudaError_t: the tensor maps'
// encoding, then cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int M, int D,
                         const long long* strides, float scale_log2, void* stream) {
  return launch<F32::K1>(q, k, v, o, nullptr, B, H, N, M, D, strides, scale_log2, 1.f, 0, stream);
}

// K3 in fp32 (bf16 K3 is flash_fwd_sm90_lse): as flash_fwd, and writes lse2
// into the contiguous fp32 [B, H, N] buffer `lse`.
extern "C" int flash_fwd_lse(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int N,
                             int M, int D, const long long* strides, float scale_log2, void* stream) {
  return launch<F32::K3>(q, k, v, o, static_cast<float*>(lse), B, H, N, M, D, strides, scale_log2, 1.f, 0, stream);
}

// K6 in fp32 (bf16 K6 is flash_fwd_sm90 with `one`): arguments as flash_fwd.
extern "C" int flash_fwd_one(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int M, int D,
                             const long long* strides, float scale_log2, void* stream) {
  return launch<F32::K6>(q, k, v, o, nullptr, B, H, N, M, D, strides, scale_log2, 1.f, 0, stream);
}
