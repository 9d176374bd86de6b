"""The diagnostic flash-attention kernels K7-K10 of the attention bench tool.

They replace the Pallas TPU kernels of tools/bench_attn_diag.py: K7, the
kernel of ``make_kernel`` (:20) that ``run`` (:64) launches in five variants
of one kv loop (``full``, ``exp2``, ``no_max``, ``no_exp``, ``matmul_only``);
K8, the kernel of ``run_fori_exp2`` (:112); K9, of ``run_grid3`` (:164); and
K10, of ``run_grid3b`` (:259).

In bf16 all four run K1's Hopper loop on the card (``csrc/flash_fwd_sm90.cuh``; C
entries ``attn_diag_sm90`` in ``csrc/attn_diag_sm90.cu`` for K7,
``attn_diag_grid3_sm90`` in ``csrc/attn_diag_grid3_sm90.cu`` for K9 and
``attn_diag_k8_k10_sm90`` in ``csrc/attn_diag_k8_k10_sm90.cu`` for K8 and
K10): wgmma products, 64-row K/V tiles from a TMA ring, 128 q rows a CTA in
two consumer warpgroups, handed the head views' pointers and strides. Each
K7 variant takes one kind of work out of that loop (the header says what
each computes a logit), so its time against K1's splits K1's. K9 is K1's
loop with the tool's start of the running max, -1e30; when the 128-row grid
is under one wave (``q_rows``) it runs 64 q rows a CTA in one warpgroup. K8
is K9 in a ring of 2 stages (K9: 4, 3 at d = 128), so K8 against K9 reads
what the deeper ring buys; K10 is K9 with ``l`` from a ones block in shared
memory under the running max, so K10 against K9 reads what that buys.

Each wrapper launches its kernel for CUDA tensors and raises if it cannot;
for CPU tensors it computes the plain PyTorch version with the kernel's
arithmetic (``diag_loop_plain``, ``flash_exp2_plain``). Inputs are
``[B, H, N, D]`` q, k, v of one shape, and so is the output. The checks are
the same on every device: ``N`` must be a multiple of ``block_q`` and
``block_k`` (the TPU grid drops the rows of a ragged tail in silence), and
K10 needs ``D % 128 != 0`` (its ones lane lives in the TPU's head-dim
padding). The bf16 CUDA kernels take ``N % 64 == 0`` and ``D % 8 == 0`` up
to 128; K7 ``exp2`` needs ``block_k`` a multiple of 64, the granularity of
its max. The other bf16 kernels do not depend on the block sizes: they run
their own q tiles and 64-row kv tiles whatever ``block_q`` and ``block_k``
are, which changes fp32 rounding only.

fp32 inputs, which the JAX tool's functions take as well, go to one SIMT
kernel of the fp32 K1's design (C entry ``attn_diag_f32`` in
``csrc/attn_diag_f32.cu``: one thread a q row, fp32 FMA, 32-row K/V tiles in
shared memory), one instance a kind; K8, K9 and K10 compute one function
in fp32 (P rounds to itself), and stay three instances under their three
counters. It computes the plain versions' blocks
as they are: full, exp2, K8, K9 and K10 commit their max once every
``block_k`` kv rows (two sweeps of each block, the first for its max), so
``block_k`` must be a multiple of 32; any ``N``, and ``D`` up to 128.

Each wrapper counts its launches in its ``launches`` attribute, keyed
``(dtype, (B, H, N, D))``; K7's key adds the variant and ``block_k``, since
one wrapper runs five kernels.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter

import torch

from audioldm_tpu_torch.kernels import _build
from audioldm_tpu_torch.kernels.flash_attention import _as_aligned, _strides, _variant

LOG2E = 1.4426950408889634
VARIANTS = ("full", "exp2", "no_max", "no_exp", "matmul_only")
_KIND = {**{name: i for i, name in enumerate(VARIANTS)}, "fori_exp2": 5, "grid3": 6, "grid3b": 7}
# the library and C entry of each kernel (K7's five variants share one)
_ENTRY = {**dict.fromkeys(VARIANTS, "attn_diag_sm90"), "grid3": "attn_diag_grid3_sm90",
          "fori_exp2": "attn_diag_k8_k10_sm90", "grid3b": "attn_diag_k8_k10_sm90"}
_TILE = 64  # kv rows of a CUDA tile, and the granularity of N
_P, _I = ctypes.c_void_p, ctypes.c_int
# attn_diag_sm90 (K7): kind, q, k, v, o, B, H, N, D, strides, scale, block_k, stream
_SM90_ARGS = [_I] + [_P] * 4 + [_I] * 4 + [_P, ctypes.c_float, _I, _P]
# attn_diag_grid3_sm90 (K9): q, k, v, o, B, H, N, D, strides, scale, rows, stream
_GRID3_ARGS = [_P] * 4 + [_I] * 4 + [_P, ctypes.c_float, _I, _P]
# attn_diag_k8_k10_sm90 (K8, K10): kind, q, k, v, o, B, H, N, D, strides, scale, stream
_K8_K10_ARGS = [_I] + [_P] * 4 + [_I] * 4 + [_P, ctypes.c_float, _P]
# attn_diag_f32 (K7-K10 in fp32): kind, q, k, v, o, B, H, N, D, strides, scale, block_k, stream
_F32_ARGS = _SM90_ARGS
_F32_TILE = 32  # kv rows of the fp32 kernel's tile: the granularity of a committed max
_COMMITS_MAX = ("full", "exp2", "fori_exp2", "grid3", "grid3b")  # the kinds whose max is committed once a block_k block


def diag_loop_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, variant: str, block_k: int) -> torch.Tensor:
    """Plain version of K7: the TPU kernel's loop over ``block_k``-row kv
    blocks in fp32, with q, k, v in their dtype and P rounded to v's dtype
    before ``P V``. ``full`` rescales by ``alpha = exp(m - m_new)`` (0 while
    ``m`` is -inf); ``exp2`` takes the running max but no rescale; ``no_max``
    ``p = exp(s)``; ``no_exp`` ``p = s``; ``matmul_only`` ``p`` the unscaled
    logits and ``l = 0``. Returns ``(acc / max(l, 1e-20))`` in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float()
    rows = q.shape[:-1] + (1,)
    m = torch.full(rows, -math.inf, device=q.device)
    l = torch.zeros(rows, device=q.device)
    acc = torch.zeros(q.shape, device=q.device)
    for i in range(k.shape[2] // block_k):
        kb, vb = (t[:, :, i * block_k : (i + 1) * block_k].float() for t in (k, v))
        s = torch.matmul(qf, kb.transpose(-1, -2))
        if variant == "matmul_only":
            acc = acc + torch.matmul(s.to(v.dtype).float(), vb)
            continue
        s = s * scale
        m_new = m
        if variant == "no_exp":
            p = s
        elif variant == "no_max":
            p = torch.exp(s)
        elif variant == "exp2":
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp2((s - m_new) * LOG2E)
        else:  # full
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0) if variant == "full" else 1.0
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vb)
        m = m_new
    return (acc / torch.clamp(l, min=1e-20)).to(q.dtype)


def flash_exp2_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_k: int, ones: bool = False) -> torch.Tensor:
    """Plain version of K8 and K9 (and, with ``ones=True``, of K10): q
    pre-scaled by ``log2(e)/sqrt(d)`` in fp32 and rounded to its dtype, then
    the online softmax over ``block_k``-row kv blocks in base 2 from
    ``m = -1e30``, P rounded to v's dtype before ``P V``, ``out = acc / l``.
    With ``ones`` the sum ``l`` is that of the rounded P, as the ones column
    of V gives it in the product."""
    qs = (q.float() * (LOG2E / math.sqrt(q.shape[-1]))).to(q.dtype).float()
    rows = q.shape[:-1] + (1,)
    m = torch.full(rows, -1e30, device=q.device)
    l = torch.zeros(rows, device=q.device)
    acc = torch.zeros(q.shape, device=q.device)
    for i in range(k.shape[2] // block_k):
        kb, vb = (t[:, :, i * block_k : (i + 1) * block_k].float() for t in (k, v))
        s = torch.matmul(qs, kb.transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_new)
        alpha = torch.exp2(m - m_new)
        pr = p.to(v.dtype).float()
        l = l * alpha + (pr if ones else p).sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(pr, vb)
        m = m_new
    return (acc / l).to(q.dtype)


def row_condition(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, variant: str) -> torch.Tensor:
    """``[B, H, N, 1]``: for each q row, in float64, the condition number
    ``sum |x_j| / |sum x_j|`` of the signed sum that ``no_exp`` and
    ``matmul_only`` divide by or return, where a softmax sums weights of
    one sign (condition 1): ``no_exp``'s ``l``, the sum of the scaled
    logits; ``matmul_only``'s ``s v`` at the row's largest output. fp32
    rounding of such a sum grows with it, so a comparison of two fp32
    orders of summation bounds a row by this times a softmax row's bound."""
    s = torch.matmul(q.double(), k.double().transpose(-1, -2))
    if variant == "no_exp":
        s = s / math.sqrt(q.shape[-1])
        return s.abs().sum(dim=-1, keepdim=True) / s.sum(dim=-1, keepdim=True).abs()
    if variant != "matmul_only":
        raise ValueError(f"row_condition: {variant!r} sums weights of one sign")
    vd = v.double()
    return torch.matmul(s.abs(), vd.abs()).amax(dim=-1, keepdim=True) / torch.matmul(s, vd).abs().amax(dim=-1, keepdim=True)


def _check(name: str, q, k, v, block_q: int, block_k: int) -> None:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must be [B, H, N, D] of one shape, got {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: dtype {q.dtype}/{k.dtype}/{v.dtype} (bf16 or fp32, all equal)")
    n, d = q.shape[2], q.shape[3]
    if block_q < 1 or block_k < 1 or n % block_q or n % block_k:
        raise ValueError(f"{name}: N={n} is not a multiple of block_q={block_q} and block_k={block_k}")
    if name == "grid3b" and d % 128 == 0:
        raise ValueError(f"grid3b: the ones lane needs D % 128 != 0, got D={d}")


def _is_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def q_rows(b: int, h: int, n: int, d: int, sms: int) -> int:
    """K9's q rows a CTA on a card of ``sms`` SMs: 64 (one consumer
    warpgroup) when the grid of 128-row tiles is under one wave, that is
    fewer CTAs than ``sms`` times the 128-row instance's CTAs an SM (2 at
    d <= 32, where its registers are sized for two, else 1); 128 otherwise."""
    return 64 if -(-n // 128) * b * h < sms * (2 if d <= 32 else 1) else 128


def _launch_f32(name: str, q, k, v, scale: float, block_k: int) -> torch.Tensor:
    """One launch of the fp32 kernel (``attn_diag_f32``) on CUDA tensors,
    handed their (b, h, n) strides; a tensor whose last dim is not unit
    stride is copied."""
    b, h, n, d = q.shape
    if d > 128:
        raise ValueError(f"{name}: the fp32 CUDA kernel holds a q row and its accumulator in registers, D <= 128; got D={d}")
    if name in _COMMITS_MAX and block_k % _F32_TILE:
        raise ValueError(f"{name}: the fp32 CUDA kernel commits the max per block_k rows in whole {_F32_TILE}-row tiles; "
                         f"got block_k={block_k}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
    err = _build.function("attn_diag_f32", "attn_diag_f32", _F32_ARGS)(
        _KIND[name], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, n, d, _strides(q, k, v, out), scale,
        block_k, stream)
    _build.check(err, f"attn_diag_f32 {name}")
    return out


def _launch(name: str, q, k, v, scale: float, block_k: int) -> torch.Tensor:
    """One launch on CUDA tensors: fp32 through ``_launch_f32``, bf16
    through the kernel's sm90 entry (``_ENTRY``), handed the head views'
    pointers and strides."""
    if q.dtype == torch.float32:
        return _launch_f32(name, q, k, v, scale, block_k)
    b, h, n, d = q.shape
    if n % _TILE or d % 8 or d > 128:
        raise ValueError(f"{name}: the CUDA kernel needs N % {_TILE} == 0 and D % 8 == 0, D <= 128; got N={n}, D={d}")
    if name == "exp2" and block_k % _TILE:
        raise ValueError(f"exp2: the CUDA kernel commits the max per block_k rows, a multiple of {_TILE}; got {block_k}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    q, k, v = (_as_aligned(t) for t in (q, k, v))
    out = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, n, d, _strides(q, k, v, out), scale)
    entry = _ENTRY[name]
    if name == "grid3":
        rows = q_rows(b, h, n, d, torch.cuda.get_device_properties(q.device).multi_processor_count)
        err = _build.function(entry, entry, _GRID3_ARGS)(*args, rows, stream)
    elif name in VARIANTS:
        err = _build.function(entry, entry, _SM90_ARGS)(_KIND[name], *args, block_k, stream)
    else:
        err = _build.function(entry, entry, _K8_K10_ARGS)(_KIND[name], *args, stream)
    _build.check(err, f"attn_diag {name}")
    return out


def diag_loop(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, variant: str, block_k: int, block_q: int = _TILE) -> torch.Tensor:
    """K7: one of ``VARIANTS`` of the tool's kv loop over ``[B, H, N, D]``."""
    if variant not in VARIANTS:
        raise ValueError(f"diag_loop: variant {variant!r} is not one of {VARIANTS}")
    _check(variant, q, k, v, block_q, block_k)
    if not _is_cuda(q):
        return diag_loop_plain(q, k, v, variant, block_k)
    out = _launch(variant, q, k, v, 1.0 / math.sqrt(q.shape[-1]), block_k)
    diag_loop.launches[_variant(q) + (variant, block_k)] += 1
    return out


def _flash(name: str, fn, q, k, v, block_q: int, block_k: int) -> torch.Tensor:
    _check(name, q, k, v, block_q, block_k)
    if not _is_cuda(q):
        return flash_exp2_plain(q, k, v, block_k, ones=name == "grid3b")
    out = _launch(name, q, k, v, LOG2E / math.sqrt(q.shape[-1]), block_k)
    fn.launches[_variant(q)] += 1
    return out


def fori_exp2(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int, block_k: int) -> torch.Tensor:
    """K8: flash forward with q pre-scaled, on K1's Hopper loop with the kv
    tiles in a ring of 2 stages (one in flight while one is computed)."""
    return _flash("fori_exp2", fori_exp2, q, k, v, block_q, block_k)


def grid3(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int, block_k: int) -> torch.Tensor:
    """K9: K8's function on K1's Hopper loop (the kv tiles in its TMA ring)."""
    return _flash("grid3", grid3, q, k, v, block_q, block_k)


def grid3b(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int, block_k: int) -> torch.Tensor:
    """K10: K9 with ``l`` from a ones column of V (the sum of the rounded
    P), rescaled with the accumulator, on K1's Hopper loop."""
    return _flash("grid3b", grid3b, q, k, v, block_q, block_k)


diag_loop.launches = Counter()  # K7
fori_exp2.launches = Counter()  # K8
grid3.launches = Counter()  # K9
grid3b.launches = Counter()  # K10
