"""K1: flash-attention forward (no lse) for the UNet's level-0 self-attention.

Replaces the Pallas TPU kernel ``_flash_kernel_nolse``
(audioldm_tpu/kernels/flash_attention.py:128, launched by
``_flash_bh(with_lse=False)`` from ``_flash_fwd_impl``). The CUDA source is
``audioldm_tpu_torch/csrc/flash_attention.cu``; it says what bounds the
kernel on an H100 (the exp2 rate of the SFU at d=16) and how its design
answers that.

``flash_attention`` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors it computes ``sdpa_plain``, the plain PyTorch version
of the same function. ``flash_attention.launches`` counts kernel launches by
variant, ``(dtype, (B, H, N, D))``.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter

import torch
import torch.nn.functional as F

from audioldm_tpu_torch.kernels import _build

_LOG2E = 1.4426950408889634
_MAX_HEAD_DIM = 128
_MIN_TOKENS = 2048  # the JAX package's routing rule, kept so both route the same calls


def set_min_tokens(n: int) -> None:
    """Routing threshold override (tests use small geometries)."""
    global _MIN_TOKENS
    _MIN_TOKENS = n


def supported(n: int, m: int, d: int) -> bool:
    """Whether ``sdpa`` routes an unmasked ``[.., n, d] x [.., m, d]`` call
    to the kernel: the JAX rule ``n >= min_tokens and d <= 128``."""
    return n >= _MIN_TOKENS and d <= _MAX_HEAD_DIM


def sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain attention over ``[B, H, N, D]``: fp32 logits (a bf16 product is
    exact in fp32, so this is the fp32-accumulated matmul) and softmax, the
    weights cast back to the input dtype for the second matmul (the JAX
    ``models/nn.py`` sdpa arithmetic)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(weights, v)


def _aligned(t: torch.Tensor) -> bool:
    """16-byte aligned rows: unit stride along d, (b, h, n) strides in
    multiples of 8 elements, a 16-byte aligned base."""
    return t.stride(-1) == 1 and all(st % 8 == 0 for st in t.stride()[:3]) and t.data_ptr() % 16 == 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d)) v`` over ``[B, H, N, D]`` (non-causal,
    unmasked). q/k/v may be strided views (head split of a projection) with
    a contiguous last dim and 16-byte aligned rows, as the UNet's are; other
    layouts are copied, and a head dim that is not a multiple of 8 is
    zero-padded. The output is ``[B, H, N, D]``, a view of a ``[B, N, H, D]``
    buffer so merging heads afterwards is free."""
    if q.device.type == "cpu":
        return sdpa_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    shape = tuple(q.shape)
    b, h, n, d = shape
    m = k.shape[2]
    if k.shape != (b, h, m, d) or v.shape != (b, h, m, d):
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention: dtype {q.dtype}/{k.dtype}/{v.dtype} (bf16 or fp32, all equal)")
    if d > _MAX_HEAD_DIM or m < 1:
        raise ValueError(f"flash_attention: head dim {d} > {_MAX_HEAD_DIM} or empty kv")
    dk = -(-d // 8) * 8  # the bf16 kernel reads rows in 16-byte pieces
    if dk != d:  # zero columns add nothing to q.k and give zero output columns
        q, k, v = (F.pad(t, (0, dk - d)) for t in (q, k, v))
    q, k, v = (t if _aligned(t) else t.clone(memory_format=torch.contiguous_format) for t in (q, k, v))
    out = torch.empty((b, n, h, dk), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    lib = _build.load("flash_attention")
    fn = lib.flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
    ]
    c_strides = (ctypes.c_longlong * 12)(*strides)
    err = fn(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, n, m, dk, ctypes.cast(c_strides, ctypes.c_void_p),
        _LOG2E / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_fwd")
    flash_attention.launches[(str(q.dtype).removeprefix("torch."), shape)] += 1
    return out if dk == d else out[..., :d]


flash_attention.launches = Counter()
