"""Flash attention for the UNet's self-attention: K1 (forward, no
lse) and K6 (the one-pass forward for a single kv block, behind a flag) for
inference, and K3-K5 (forward with lse, dK/dV, dQ) behind a
``torch.autograd.Function`` for training.

They replace the Pallas TPU kernels of audioldm_tpu/kernels/flash_attention.py:
K1 ``_flash_kernel_nolse`` (:128), K3 ``_flash_kernel`` (:86), K4
``_flash_bwd_dkv_kernel`` (:237), K5 ``_flash_bwd_dq_kernel`` (:264), the
last three wrapped there in a ``custom_vjp``, and K6 ``_flash_kernel_one``
(:133). The CUDA sources are ``audioldm_tpu_torch/csrc/flash_fwd_sm90.cu``
(K1, K6 and K3 in bf16: wgmma, a TMA ring, 128-row q tiles),
``csrc/flash_bwd_sm90.cu`` (K4 and K5 in bf16, of the same design),
``csrc/flash_attention.cu`` (K1, K3 and K6 in fp32: 3xTF32 on wgmma, TMA,
one loop in ``csrc/flash_fwd_f32.cuh``) and
``csrc/flash_attention_bwd.cu`` (K4, K5 in fp32: 3xTF32 on wgmma, TMA); they say what bounds the kernels
on an H100 (the exp2 rate of the SFU at d=16 in bf16, the products at fp32
accuracy in fp32) and how their designs answer that.

``flash_attention`` launches the kernels for CUDA tensors and raises if it
cannot; for CPU tensors it computes the plain PyTorch versions of the same
functions (``flash_plain``, ``flash_one_plain``, ``flash_fwd_lse_plain``,
``flash_bwd_plain``). Every kernel computes with q pre-scaled by
``log2(e)/sqrt(d)`` and rounded to q's dtype (``prescale``), as the JAX
package's wrapper hands it to its kernels: K1 and K6 round it as they load
q, K3-K5 are handed it; K4 multiplies its fp32 ``dS^T q2`` by
``1/(scale log2(e))``, as the TPU kernel does. When grad is enabled and an input
requires grad it goes through the Function (K3 forward, K4 + K5 backward),
otherwise through K1 or, with ``set_one_pass(True)`` and a kv axis of one
block, K6; their outputs have no ``grad_fn``. Each launcher counts its
launches by variant, ``(dtype, (B, H, N, D))``, in its ``launches`` attribute.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from collections import Counter

import torch
import torch.nn.functional as F

from audioldm_tpu_torch.kernels import _build

_LOG2E = 1.4426950408889634
_MAX_HEAD_DIM = 128
# Unmasked calls of at least this many tokens go to the kernels. On the CPU
# it is the JAX package's rule (below 2048 tokens XLA's fused attention is
# already optimal on the TPU), kept so that both packages route the same
# calls in the parity tests. On the card ``sdpa_plain`` is not fused: it
# writes the fp32 [B, H, N, M] logits and reads them back for the scale, the
# softmax, the cast and P V, so the kernels win at fewer tokens: K1, and K3-K5
# under autograd, beat it at the UNet's level 2 (256 tokens of d = 48) in bf16
# and fp32 on an H100 (PERF.md's kernel table). The mid block (64 tokens)
# stays plain.
_MIN_TOKENS = 2048
_CARD_MIN_TOKENS = 256
# K6 takes a call only when the whole kv axis is one block of the JAX
# package's kernel: 4096 rows in bf16, 2048 in fp32. These are TPU block
# sizes (what fits VMEM), kept so that both packages route the same calls.
_ONE_BLOCK = {torch.bfloat16: 4096, torch.float32: 2048}
_ONE_PASS = False  # off by default, as the JAX package's ``_ONE_PASS`` is


def set_min_tokens(n: int) -> None:
    """Set the token threshold of both routing rules, the CPU's and the
    card's, to ``n``: tests lower it to route small geometries through the
    kernels, tools raise it to send every call to ``sdpa_plain``."""
    global _MIN_TOKENS, _CARD_MIN_TOKENS
    _MIN_TOKENS = _CARD_MIN_TOKENS = n


@contextlib.contextmanager
def min_tokens(n: int):
    """``set_min_tokens(n)`` inside the block; both thresholds restored
    after it."""
    global _MIN_TOKENS, _CARD_MIN_TOKENS
    saved = _MIN_TOKENS, _CARD_MIN_TOKENS
    set_min_tokens(n)
    try:
        yield
    finally:
        _MIN_TOKENS, _CARD_MIN_TOKENS = saved


def set_one_pass(enabled: bool) -> None:
    """Route single-kv-block inference calls of ``flash_attention`` to the
    one-pass kernel K6 instead of the streaming kernel K1."""
    global _ONE_PASS
    _ONE_PASS = bool(enabled)


def one_pass() -> bool:
    return _ONE_PASS


def one_pass_routes(m: int, d: int, dtype: torch.dtype) -> bool:
    """Whether an inference call with ``m`` kv rows and head dim ``d`` goes
    to K6: the flag is on, the kv axis is one block and the head dim leaves
    room for the ones column (the JAX rule: ``nkv == 1`` and ``d < 128``)."""
    return _ONE_PASS and d < _MAX_HEAD_DIM and m <= _ONE_BLOCK.get(dtype, 0)


def supported(n: int, m: int, d: int) -> bool:
    """The JAX rule, which ``routes`` applies to CPU tensors: ``n >=
    min_tokens and d <= 128``."""
    return n >= _MIN_TOKENS and d <= _MAX_HEAD_DIM


def routes(device: torch.device, n: int, m: int, d: int, masked: bool = False) -> bool:
    """Whether ``sdpa`` sends a ``[.., n, d] x [.., m, d]`` call on
    ``device`` to ``flash_attention``: never a masked call; on CUDA an
    unmasked one with ``n`` at or above the card's threshold and ``d <=
    128``; elsewhere the JAX rule (``supported``)."""
    if masked:
        return False
    if device.type == "cuda":
        return n >= _CARD_MIN_TOKENS and d <= _MAX_HEAD_DIM
    return supported(n, m, d)


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


def prescale(q: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """``q2 = q * scale * log2(e)``, the product in fp32 rounded to q's dtype:
    the q that every flash kernel computes with (the JAX package's
    ``_pad_reshape``). ``scale`` defaults to ``1/sqrt(d)``."""
    return (q.float() * ((scale or 1.0 / math.sqrt(q.shape[-1])) * _LOG2E)).to(q.dtype)


def flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 over ``[B, H, N, D]``, with the kernel's
    arithmetic: ``s2 = prescale(q) k^T`` in fp32, ``P = exp2(s2 - m)`` with
    ``m`` the row max, ``l`` the fp32 sum of ``P``, ``P`` rounded to v's
    dtype before ``P v`` (fp32 accumulation), ``out = (P v) / l``. The
    kernel's running max rescales what it has summed when a row's max
    grows; the sums agree to fp32 rounding."""
    s2 = torch.matmul(prescale(q).float(), k.float().transpose(-1, -2))
    p = torch.exp2(s2 - s2.amax(dim=-1, keepdim=True))
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / p.sum(dim=-1, keepdim=True)
    return out.to(q.dtype)


def flash_one_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of K6 over ``[B, H, N, D]``, with the kernel's
    arithmetic: ``s2 = prescale(q) k^T`` in fp32, the max ``m`` of each
    whole row, ``P = exp2(s2 - m)`` rounded to v's dtype, one product
    ``[O | l] = P [V | 1]`` accumulated in fp32 (so the denominator ``l`` is
    the sum of the rounded ``P``), and ``out = O / l``."""
    d = q.shape[-1]
    s2 = torch.matmul(prescale(q).float(), k.float().transpose(-1, -2))
    p = torch.exp2(s2 - s2.amax(dim=-1, keepdim=True)).to(v.dtype).float()
    v1 = torch.cat([v.float(), torch.ones_like(v[..., :1], dtype=torch.float32)], dim=-1)
    o = torch.matmul(p, v1)
    return (o[..., :d] / o[..., d:]).to(q.dtype)


def flash_fwd_lse_plain(q2: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3 over ``[B, H, N, D]``: ``(out, lse2)`` with the
    kernel's arithmetic. ``q2 = prescale(q)`` comes pre-scaled by
    ``log2(e)/sqrt(d)`` and rounded to the input dtype (the JAX wrapper's
    ``_pad_reshape``); ``s2 = q2 k^T`` in fp32, ``P = exp2(s2 - max)``
    rounded to the input dtype before ``P v`` (fp32 accumulation), the
    result divided by ``l = rowsum(P)`` (fp32 P), and ``lse2 = max +
    log2(l)`` fp32 ``[B, H, N]``."""
    s2 = torch.matmul(q2.float(), k.float().transpose(-1, -2))
    m = s2.amax(dim=-1, keepdim=True)
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(q2.dtype).float(), v.float()) / l
    return out.to(q2.dtype), (m + torch.log2(l)).squeeze(-1)


def flash_bwd_plain(
    q2: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse2: torch.Tensor, dout: torch.Tensor,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K4 + K5: ``(dq, dk, dv)`` with the kernels'
    arithmetic, in the order of roundings of the TPU kernels
    (audioldm_tpu/kernels/flash_attention.py:251-260, :274-281). ``q2`` is
    the forward's pre-scaled q; ``P = exp2(q2 k^T - lse2)`` is recomputed
    from the forward's lse2, ``delta = rowsum(dO o O)``, ``dS = P o (dO v^T -
    delta) * scale`` (``scale`` defaults to ``1/sqrt(D)``); P and dS are
    rounded to the input dtype before ``dV = P^T dO``, ``dK = (dS^T q2) /
    (scale * log2(e))`` (the factor applied to the fp32 product) and ``dQ =
    dS k``, which accumulate in fp32."""
    dt = q2.dtype
    scale = scale or 1.0 / math.sqrt(q2.shape[-1])
    qf, kf, vf, dof = q2.float(), k.float(), v.float(), dout.float()
    p = torch.exp2(torch.matmul(qf, kf.transpose(-1, -2)) - lse2[..., None])
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    ds = (p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta) * scale).to(dt).float()
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), dof)
    dk = torch.matmul(ds.transpose(-1, -2), qf) * (1.0 / (scale * _LOG2E))
    dq = torch.matmul(ds, kf)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _aligned(t: torch.Tensor) -> bool:
    """16-byte aligned rows: unit stride along d, (b, h, n) strides in
    multiples of 8 elements, a 16-byte aligned base."""
    s = t.stride()
    return s[3] == 1 and not (s[0] | s[1] | s[2]) % 8 and not t.data_ptr() % 16


def _as_aligned(t: torch.Tensor) -> torch.Tensor:
    return t if _aligned(t) else t.clone(memory_format=torch.contiguous_format)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    b, h, _, d = q.shape
    m = k.shape[2]
    if k.shape != (b, h, m, d) or v.shape != (b, h, m, d):
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention: dtype {q.dtype}/{k.dtype}/{v.dtype} (bf16 or fp32, all equal)")
    if d > _MAX_HEAD_DIM or m < 1:
        raise ValueError(f"flash_attention: head dim {d} > {_MAX_HEAD_DIM} or empty kv")


def _heads_buffer(like: torch.Tensor) -> torch.Tensor:
    """An empty ``[B, H, N, D]`` view of a ``[B, N, H, D]`` buffer, so that
    merging heads (or the backward of splitting them) is free."""
    b, h, n, d = like.shape
    return torch.empty_strided((b, h, n, d), (n * h * d, d, h * d, 1), dtype=like.dtype, device=like.device)


def _variant(t: torch.Tensor, shape=None) -> tuple:
    return (_DTYPE[t.dtype], tuple(shape or t.shape))


def _strides(*tensors):
    """The (b, h, n) element strides of ``tensors`` as a C array (ctypes
    keeps it alive for the duration of the call it is passed to)."""
    flat = ()
    for t in tensors:
        flat += t.stride()[:3]
    return (ctypes.c_longlong * len(flat))(*flat)


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_TAIL = [_I] * 5 + [_P, ctypes.c_float]
_SM90_ARGS = [_P] * 4 + _FWD_TAIL + [_I, _P]  # flash_fwd_sm90: q, k, v, o, B, H, N, M, D, strides, c, one, stream
_FWD_ARGS = [_P] * 4 + _FWD_TAIL + [_P]  # flash_fwd, flash_fwd_one (fp32): q, k, v, o, B, H, N, M, D, strides, c, stream
# K3: flash_fwd_sm90_lse (bf16), flash_fwd_lse (fp32): q2, k, v, o, lse, B, H, N, M, D, strides, c, stream
_LSE_ARGS = [_P] * 5 + _FWD_TAIL + [_P]
# K4: ..., dk, dv, B, H, N, M, D, strides, scale, dk_scale, stream; K5: ..., dq, B, H, N, M, D, strides, scale, stream
_BWD_ARGS = {"flash_bwd_dkv": [_I] + [_P] * 8 + [_I] * 5 + [_P, ctypes.c_float, ctypes.c_float, _P],
             "flash_bwd_dq": [_I] + [_P] * 7 + [_I] * 5 + [_P, ctypes.c_float, _P]}
_DTYPE = {torch.bfloat16: "bfloat16", torch.float32: "float32"}


def _launch_fwd(q, k, v, scale: float, one: bool) -> torch.Tensor:
    """K1 (or K6 with ``one``) on aligned CUDA tensors with ``d % 8 == 0``:
    bf16 in ``flash_fwd_sm90.cu``, fp32 in ``flash_attention.cu``."""
    b, h, n, d = q.shape
    out = _heads_buffer(q)
    strides = _strides(q, k, v, out)
    args = (b, h, n, k.shape[2], d, strides, _LOG2E * scale)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.bfloat16:
        err = _build.function("flash_fwd_sm90", "flash_fwd_sm90", _SM90_ARGS)(*ptrs, *args, int(one), stream)
    else:
        err = _build.function("flash_attention", "flash_fwd_one" if one else "flash_fwd", _FWD_ARGS)(*ptrs, *args, stream)
    _build.check(err, "flash_fwd_one" if one else "flash_fwd")
    return out


def _launch_lse(q2, k, v) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 on aligned CUDA tensors with ``d % 8 == 0``: bf16 in the lse
    variant of ``flash_fwd_sm90.cu``, fp32 in ``flash_attention.cu``. q2 is
    already pre-scaled: the kernels are handed 1.0 for the scale."""
    b, h, n, d = q2.shape
    out = _heads_buffer(q2)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q2.device)
    lib, fn = ("flash_fwd_sm90", "flash_fwd_sm90_lse") if q2.dtype == torch.bfloat16 else ("flash_attention", "flash_fwd_lse")
    err = _build.function(lib, fn, _LSE_ARGS)(
        q2.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, h, n, k.shape[2], d, _strides(q2, k, v, out), 1.0, torch.cuda.current_stream(q2.device).cuda_stream)
    _build.check(err, fn)
    return out, lse


def flash_fwd_lse(q2: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: ``(out, lse2)`` over ``[B, H, N, D]`` from the pre-scaled
    ``q2 = prescale(q)``; the kernel on CUDA tensors, ``flash_fwd_lse_plain``
    on CPU tensors. CUDA inputs must have 16-byte aligned rows and
    ``D % 8 == 0`` (``flash_attention`` sees to both)."""
    if q2.device.type == "cpu":
        return flash_fwd_lse_plain(q2, k, v)
    out, lse = _launch_lse(q2, k, v)
    flash_fwd_lse.launches[_variant(q2)] += 1
    return out, lse


def _launch_bwd(name: str, q2, k, v, dout, lse2, delta, outs, scale: float | None) -> None:
    """Launch ``flash_bwd_dkv`` (``outs = (dk, dv)``) or ``flash_bwd_dq``
    (``outs = (dq,)``) on aligned CUDA tensors with ``d % 8 == 0``: bf16 in
    ``flash_bwd_sm90.cu``, fp32 in ``flash_attention_bwd.cu``."""
    b, h, n, d = q2.shape
    scale = scale or 1.0 / math.sqrt(d)
    factors = (scale, 1.0 / (scale * _LOG2E)) if name == "flash_bwd_dkv" else (scale,)
    bf16 = q2.dtype == torch.bfloat16
    err = _build.function("flash_bwd_sm90" if bf16 else "flash_attention_bwd", name, _BWD_ARGS[name])(
        int(bf16), q2.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse2.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs), b, h, n, k.shape[2], d,
        _strides(q2, k, v, dout, outs[0], outs[-1]), *factors, torch.cuda.current_stream(q2.device).cuda_stream,
    )
    _build.check(err, name)


def flash_bwd_dkv(q2, k, v, dout, lse2, delta, scale: float | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 on CUDA tensors: ``(dk, dv)``, each a ``[B, H, M, D]`` view of a
    ``[B, M, H, D]`` buffer. q2 (the forward's pre-scaled q), k, v, dout:
    aligned rows, ``D % 8 == 0``; lse2 (from K3) and ``delta = rowsum(dO o
    O)``: contiguous fp32 ``[B, H, N]``."""
    dk, dv = _heads_buffer(k), _heads_buffer(v)
    _launch_bwd("flash_bwd_dkv", q2, k, v, dout, lse2, delta, (dk, dv), scale)
    flash_bwd_dkv.launches[_variant(q2)] += 1
    return dk, dv


def flash_bwd_dq(q2, k, v, dout, lse2, delta, scale: float | None = None) -> torch.Tensor:
    """K5 on CUDA tensors: ``dq``, a ``[B, H, N, D]`` view of a ``[B, N, H,
    D]`` buffer. Inputs as for ``flash_bwd_dkv``."""
    dq = _heads_buffer(q2)
    _launch_bwd("flash_bwd_dq", q2, k, v, dout, lse2, delta, (dq,), scale)
    flash_bwd_dq.launches[_variant(q2)] += 1
    return dq


def flash_bwd(q2, k, v, out, lse2, dout, scale: float | None = None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of flash attention from the forward's pre-scaled
    ``q2``: K4 and K5 on CUDA tensors, ``flash_bwd_plain`` on CPU tensors.
    ``delta = rowsum(dO o O)`` is a PyTorch reduction, as it is an XLA one
    in the JAX package. ``dout`` may have any layout; it is copied if its
    rows are not 16-byte aligned."""
    if q2.device.type == "cpu":
        return flash_bwd_plain(q2, k, v, out, lse2, dout, scale)
    dout = _as_aligned(dout)
    delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
    lse2 = lse2.contiguous()
    dk, dv = flash_bwd_dkv(q2, k, v, dout, lse2, delta, scale)
    return flash_bwd_dq(q2, k, v, dout, lse2, delta, scale), dk, dv


class _FlashFunction(torch.autograd.Function):
    """Differentiable flash attention: forward K3, backward K4 and K5 (their
    plain versions on CPU tensors), all three on ``q2 = prescale(q)`` with
    ``scale = 1/sqrt(d)`` of the unpadded head dim, as the JAX package's
    ``custom_vjp`` hands its kernels q2. Saves q2, k, v, out and lse2;
    nothing is modified in place."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        scale = scale or 1.0 / math.sqrt(q.shape[-1])
        q2 = prescale(q, scale)
        if q.is_cuda:
            q2, k, v = (_as_aligned(t) for t in (q2, k, v))
        out, lse = flash_fwd_lse(q2, k, v)
        ctx.save_for_backward(q2, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        return (*flash_bwd(*ctx.saved_tensors, dout, ctx.scale), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d)) v`` over ``[B, H, N, D]`` (non-causal,
    unmasked). q/k/v may be strided views (head split of a projection) with
    a contiguous last dim and 16-byte aligned rows, as the UNet's are; other
    layouts are copied, and a head dim that is not a multiple of 8 is
    zero-padded. The output is ``[B, H, N, D]``, a view of a ``[B, N, H, D]``
    buffer so merging heads afterwards is free.

    With grad enabled and an input that requires grad the call is
    differentiable (K3, then K4 + K5 in the backward); otherwise it is K1
    or, where ``one_pass_routes`` says so, K6, whose outputs carry no graph."""
    needs_grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    one = not needs_grad and one_pass_routes(k.shape[2], q.shape[3], q.dtype)
    if q.device.type == "cpu":
        if needs_grad:
            return _FlashFunction.apply(q, k, v, None)
        return flash_one_plain(q, k, v) if one else flash_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    shape = tuple(q.shape)
    d = shape[3]
    dk = -(-d // 8) * 8  # the bf16 kernels read rows in 16-byte pieces
    if dk != d:  # zero columns add nothing to q.k and give zero output columns
        q, k, v = (F.pad(t, (0, dk - d)) for t in (q, k, v))
    scale = 1.0 / math.sqrt(d)
    if needs_grad:  # K3-K5 count their launches under the padded shape
        out = _FlashFunction.apply(q, k, v, scale)
    else:
        out = _launch_fwd(_as_aligned(q), _as_aligned(k), _as_aligned(v), scale, one)
        (flash_attention.launches_one if one else flash_attention.launches)[_variant(q, shape)] += 1
    return out if dk == d else out[..., :d]


flash_attention.launches = Counter()  # K1
flash_attention.launches_one = Counter()  # K6
flash_fwd_lse.launches = Counter()  # K3
flash_bwd_dkv.launches = Counter()  # K4
flash_bwd_dq.launches = Counter()  # K5
