"""K2: one fused HiFi-GAN multi-receptive-field (MRF) stage.

Replaces the Pallas TPU kernel ``_mrf_kernel``
(audioldm_tpu/kernels/mrf_conv.py:120, launched by
``_fused_mrf_stage_impl``). The CUDA source is
``audioldm_tpu_torch/csrc/mrf_conv.cu``; it says what bounds the kernel on an
H100 (~127 GFLOP per 10 s clip against ~42 MB of traffic per stage: at fp32
accuracy, three TF32 tensor-core products a term) and how the design keeps
the 18-conv chain on chip, computes each conv as an implicit GEMM on wgmma
with a 3xTF32 split, and streams the weights through shared memory.

``mrf_stage`` launches the kernel for CUDA tensors and raises if it cannot;
for CPU tensors it computes ``mrf_stage_plain``, the resblock chain with
``F.conv1d``. ``mrf_stage.launches`` counts kernel launches by variant,
``((B, C, T), post_k)``. ``split_tf32`` and ``pack_planes`` are the
wrapper's weight packing, which the CPU tests hold to the conv weights.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch
import torch.nn.functional as F

from audioldm_tpu_torch.kernels import _build

_HALO = 64  # most context samples per side the kernel holds
_MAX_PAD = 32  # largest single-conv pad of the routing rule
_MAX_POST_PAD = 8
_MAX_CHANNELS = 64
_KERNEL_SIZES = (3, 7, 11)  # audioldm-s's resblocks (the routing rule)
_MAX_BLOCKS = 3  # resblocks per stage and units per resblock (csrc/mrf_conv.cu MAXR, MAXU)
_MIN_T = 256  # the JAX rule (shortest block of pick_block_t), kept so both route the same stages
_TF32_DROP = 13  # fp32 mantissa bits that tf32 drops


def receptive_halo(kernel_sizes, dilations) -> int:
    """Samples of context one output of the stage needs on each side."""
    return max(sum((k - 1) * d // 2 + (k - 1) // 2 for d in dils) for k, dils in zip(kernel_sizes, dilations))


def topology_ok(kernel_sizes, dilations, post_k: int) -> bool:
    """Whether the kernel takes this resblock topology (+ conv_post taps)."""
    post_pad = (post_k - 1) // 2 if post_k else 0
    return (
        1 <= len(kernel_sizes) <= _MAX_BLOCKS
        and all(k in _KERNEL_SIZES for k in kernel_sizes)
        and all(1 <= len(d) <= _MAX_BLOCKS for d in dilations)
        and all((k - 1) * d // 2 <= _MAX_PAD for k, dils in zip(kernel_sizes, dilations) for d in dils)
        and post_pad <= _MAX_POST_PAD
        and receptive_halo(kernel_sizes, dilations) + post_pad <= _HALO
    )


def supported(t: int, c: int, dtype) -> bool:
    """Per-stage rule: fp32, at most 64 channels, at least 256 samples."""
    return dtype == torch.float32 and c <= _MAX_CHANNELS and t >= _MIN_T


def mrf_stage_plain(x, blocks, kernel_sizes, dilations, slope: float, post=None) -> torch.Tensor:
    """``mean_j resblock_j(x)`` over channel-major ``x`` [B, C, T] with
    ``F.conv1d`` (zero-padded convs); with ``post`` (a Conv1d to one
    channel) also ``tanh(post(leaky_0.01(.)))``, giving [B, 1, T]."""
    acc = None
    for blk, k, dils in zip(blocks, kernel_sizes, dilations):
        r = x
        for d, dil in enumerate(dils):
            c1, c2 = blk.convs1[d], blk.convs2[d]
            h = F.conv1d(F.leaky_relu(r, slope), c1.weight, c1.bias, padding=(k * dil - dil) // 2, dilation=dil)
            h = F.conv1d(F.leaky_relu(h, slope), c2.weight, c2.bias, padding=(k - 1) // 2)
            r = h + r
        acc = r if acc is None else acc + r
    out = acc / len(blocks)
    if post is not None:
        kp = post.weight.shape[-1]
        out = torch.tanh(F.conv1d(F.leaky_relu(out, 0.01), post.weight, post.bias, padding=(kp - 1) // 2))
    return out


def split_tf32(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` fp32 tensors with ``w ~ hi + lo``: ``hi`` is ``w``
    rounded to tf32 (10 mantissa bits, round to nearest, ties away from
    zero: ``cvt.rna.tf32.f32``), ``lo`` the same rounding of ``w - hi``; both
    have their 13 low mantissa bits zero, and ``hi + lo`` misses ``w`` by
    at most ~2^-22 of |w|. By bit arithmetic, so that the CPU computes it as
    the card does."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + (1 << (_TF32_DROP - 1))) & ~((1 << _TF32_DROP) - 1)).view(torch.float32)

    w = w.float()
    hi = rna(w)
    return hi, rna(w - hi)


def pack_planes(w: torch.Tensor, cp: int) -> torch.Tensor:
    """A conv's weights ``[co, ci, k]`` as the kernel streams them: for each
    tap, a hi plane then a lo plane (``split_tf32``) of the ``[cp, cp]``
    (co, ci) matrix, channels zero-padded to ``cp``, each plane in wgmma's
    no-swizzle K-major core-matrix order ``[co/8][ci/4][8][4]``. Returns a
    flat fp32 tensor of ``2 k cp^2`` values."""
    co, ci, k = w.shape
    wt = torch.zeros((k, cp, cp), dtype=torch.float32, device=w.device)
    wt[:, :co, :ci] = w.detach().float().permute(2, 0, 1)
    planes = torch.stack(split_tf32(wt), dim=1)  # [k, 2, cp, cp]
    return planes.reshape(k, 2, cp // 8, 8, cp // 4, 4).permute(0, 1, 2, 4, 3, 5).reshape(-1)


def kernel_channels(c: int) -> int:
    """The padded channel count the kernel computes with: 16, 32 or 64."""
    return 16 if c <= 16 else 32 if c <= 32 else 64


def _pack(blocks, dilations, c: int, cp: int, device):
    """Every conv's weights through ``pack_planes``, conv1 then conv2 per
    unit, in one buffer; biases ``[r, u, 2, cp]``. Cached on the first conv
    module, keyed by every parameter's storage and version counter:
    repacked only when a parameter was replaced or changed. Parameters made
    or loaded under ``torch.inference_mode()`` have no version counter and
    may change in place unseen, so with any of them nothing is cached and
    every call repacks."""
    convs = [conv for blk, dils in zip(blocks, dilations) for d in range(len(dils)) for conv in (blk.convs1[d], blk.convs2[d])]
    params = [t for conv in convs for t in (conv.weight, conv.bias) if t is not None]
    cached = not any(t.is_inference() for t in params)
    key = (cp,) + tuple((t.data_ptr(), t._version) for t in params) if cached else None
    hit = getattr(convs[0], "_mrf_packed", None)
    if cached and hit is not None and hit[0] == key:
        return hit[1], hit[2]
    ws, bs = [], []
    for conv in convs:
        ws.append(pack_planes(conv.weight.to(device), cp))
        b = torch.zeros((cp,), dtype=torch.float32, device=device)
        if conv.bias is not None:
            b[:c] = conv.bias.detach().float()
        bs.append(b)
    w, b = torch.cat(ws).contiguous(), torch.cat(bs).contiguous()
    convs[0]._mrf_packed = (key, w, b) if cached else None
    return w, b


def _geometry(x, kernel_sizes, dilations, post_k: int):
    """The C interface's geometry arguments: (B, C, CP, T, nres, nunit, ks,
    dils, halo)."""
    bsz, c, t = x.shape
    nunit = len(dilations[0])
    ks = (ctypes.c_int * len(kernel_sizes))(*kernel_sizes)
    dils = (ctypes.c_int * (len(kernel_sizes) * nunit))(*[d for ds in dilations for d in ds])
    halo = receptive_halo(kernel_sizes, dilations) + ((post_k - 1) // 2 if post_k else 0)
    return bsz, c, kernel_channels(c), t, len(kernel_sizes), nunit, ks, dils, halo


def plan(x: torch.Tensor, kernel_sizes, dilations, slope: float, post_k: int) -> dict:
    """What the kernel would launch for this stage on the current card:
    samples a CTA writes, ring stages, dynamic shared memory, CTAs."""
    bsz, c, cp, t, nres, nunit, ks, dils, halo = _geometry(x, kernel_sizes, dilations, post_k)
    out = (ctypes.c_int * 4)()
    fn = _build.function("mrf_conv", "mrf_stage_plan", [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    _build.check(fn(bsz, c, cp, t, nres, nunit, ctypes.cast(ks, ctypes.c_void_p), ctypes.cast(dils, ctypes.c_void_p),
                    float(slope), post_k, halo, ctypes.cast(out, ctypes.c_void_p)), "mrf_stage_plan")
    return dict(zip(("tile_samples", "ring_stages", "smem_bytes", "ctas"), out))


def _stage_args(x, blocks, kernel_sizes, dilations, slope: float, post):
    """The C function's arguments but for x, y and the stream: the packed
    weights, biases and conv_post (w, bias, wp, bp), then (B, C, CP, T,
    nres, nunit, ks, dils, slope, post_k, halo) with ``ks`` and ``dils`` as
    ctypes int arrays, and y's shape."""
    post_k = int(post.weight.shape[-1]) if post is not None else 0
    bsz, c, cp, t, nres, nunit, ks, dils, halo = _geometry(x, kernel_sizes, dilations, post_k)
    w, b = _pack(blocks, dilations, c, cp, x.device)
    if post is not None:
        wpost = post.weight.detach().float().reshape(c, post_k).contiguous()
        bpost = (post.bias.detach().float() if post.bias is not None else torch.zeros(1, device=x.device)).contiguous()
    else:
        wpost = bpost = w  # not read without post
    ints = (bsz, c, cp, t, nres, nunit, ks, dils, float(slope), post_k, halo)
    return (w, b, wpost, bpost), ints, (bsz, 1 if post is not None else c, t)


def mrf_stage(x: torch.Tensor, blocks, kernel_sizes, dilations, slope: float, post=None) -> torch.Tensor:
    """The fused stage (see ``mrf_stage_plain`` for the function). ``x``:
    channel-major [B, C, T] fp32; ``blocks``: the stage's resblocks (each
    with ``convs1``/``convs2`` Conv1d lists); ``post``: optional conv_post."""
    if x.device.type == "cpu":
        return mrf_stage_plain(x, blocks, kernel_sizes, dilations, slope, post)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stage: unsupported device {x.device}")
    bsz, c, t = x.shape
    post_k = int(post.weight.shape[-1]) if post is not None else 0
    if x.dtype != torch.float32 or c > _MAX_CHANNELS:
        raise ValueError(f"mrf_stage: needs fp32 with C <= {_MAX_CHANNELS}, got {x.dtype} C={c}")
    if not topology_ok(kernel_sizes, dilations, post_k) or len({len(d) for d in dilations}) != 1:
        raise ValueError(f"mrf_stage: unsupported topology {kernel_sizes} {dilations} post_k={post_k}")
    x = x.contiguous()
    tensors, (bsz, c, cp, t, nres, nunit, ks, dils, slope, post_k, halo), out_shape = _stage_args(
        x, blocks, kernel_sizes, dilations, slope, post)
    y = torch.empty(out_shape, dtype=torch.float32, device=x.device)
    fn = _build.function("mrf_conv", "mrf_stage", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ])
    err = fn(x.data_ptr(), y.data_ptr(), *(t_.data_ptr() for t_ in tensors), bsz, c, cp, t, nres, nunit,
             ctypes.cast(ks, ctypes.c_void_p), ctypes.cast(dils, ctypes.c_void_p), slope, post_k, halo,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "mrf_stage")
    mrf_stage.launches[(tuple(x.shape), post_k)] += 1
    return y


mrf_stage.launches = Counter()
