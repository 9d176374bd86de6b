"""The least time an NVIDIA H100 SXM could take for each hand-written kernel
launch of the served and trained paths, from the launch's shape: the work
the function needs (bytes read and written once, matmul FLOPs, one exp2 a
logit), whatever kernel runs it, over the card's peaks. A kernel's roofline
share is this bound over its measured device time.

The arithmetic is the program's (``chip_smoke.py`` ``bound`` and its kernel
cases): flash attention over ``[B, H, N, D]`` reads q, k, v and writes o
(K3 also the fp32 log-sum-exp row; K4 reads q, k, v, dO and two rows and
writes dK, dV; K5 reads the same and writes dQ), computes 2, 4 and 3
products of 2 B H N^2 D FLOPs (K1, K3: 2; K4: 4; K5: 3) and one exp2 a
logit; K2 (one multi-receptive-field stage of the vocoder) reads x and the
weights, writes y, and computes 2 C^2 T taps over 6 convolutions a kernel
size. bf16 products run at the bf16 tensor rate; the fp32 kernels run
three TF32 products a term, so their products count at a third of the TF32
rate.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
FP32_FMA_FLOPS = 67e12
# exp2 on the SFU: 16 a clock an SM (CUDA programming guide, compute capability 9.0) x 132 SMs x 1.98 GHz
SFU_EXP2_PER_S = 16 * 132 * 1.98e9
# the rate of a product a kernel of this precision computes: bf16 directly, fp32 as three TF32 products
PRODUCT_FLOPS = {"bfloat16": BF16_FLOPS, "float32": TF32_FLOPS / 3}
_ELEMENT = {"bfloat16": 2, "float32": 4}
MRF_KERNEL_SIZES = (3, 7, 11)


def bound_s(nbytes: float, flops: float, flops_per_s: float, exp2: float = 0.0) -> float:
    """Bytes over HBM bandwidth, or operations over their peak (the FLOPs at
    ``flops_per_s``, the exp2 at the SFU's rate), whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s, exp2 / SFU_EXP2_PER_S)


def flash(kernel: str, dtype: str, shape) -> dict:
    """Work of one launch of K1 (forward), K6 (one-pass forward), K3
    (forward with log-sum-exp), K4 (dK, dV) or K5 (dQ) at ``shape``
    ``(B, H, N, D)`` with q, k, v of ``dtype``."""
    b, h, n, d = shape
    bh = b * h
    io = bh * n * d * _ELEMENT[dtype]
    rows = bh * n * 4
    nbytes, products = {
        "K1": (4 * io, 2), "K6": (4 * io, 2), "K3": (4 * io + rows, 2), "K4": (6 * io + 2 * rows, 4), "K5": (5 * io + 2 * rows, 3),
    }[kernel]
    return {"bytes": nbytes, "flops": products * 2 * bh * n * n * d, "exp2": bh * n * n}


def flash_bound_s(kernel: str, dtype: str, shape) -> float:
    w = flash(kernel, dtype, shape)
    return bound_s(w["bytes"], w["flops"], PRODUCT_FLOPS[dtype], w["exp2"])


def mrf(shape, post_k: int, kernel_sizes=MRF_KERNEL_SIZES) -> dict:
    """Work of one K2 launch on fp32 ``x`` of ``shape`` ``(B, C, T)``, with
    conv_post (``post_k`` taps) fused into its epilogue when ``post_k``."""
    b, c, t = shape
    taps = 6 * sum(kernel_sizes)
    flops = b * (2 * c * c * t * taps + (2 * c * post_k * t if post_k else 0))
    nbytes = 4 * (b * (c * t + (t if post_k else c * t)) + c * c * taps)
    return {"bytes": nbytes, "flops": flops}


def mrf_bound_s(shape, post_k: int) -> float:
    w = mrf(shape, post_k)
    return bound_s(w["bytes"], w["flops"], PRODUCT_FLOPS["float32"])


def launch_bound_s(kernel: str, variant) -> float:
    """The bound of one launch under the launch counter's variant key: K1,
    K3-K6 count ``(dtype, (B, H, N, D))``, K2 counts ``((B, C, T), post_k)``."""
    if kernel == "K2":
        shape, post_k = variant
        return mrf_bound_s(shape, post_k)
    dtype, shape = variant
    return flash_bound_s(kernel, dtype, shape)
