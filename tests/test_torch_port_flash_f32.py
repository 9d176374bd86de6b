"""The arithmetic of the fp32 forward loop (csrc/flash_fwd_f32.cuh
``flash_fwd_f32``: 3xTF32 on wgmma) modelled in plain PyTorch on the CPU,
against the port's plain versions and the JAX package's Pallas kernels in
interpret mode: K1 and K3 (csrc/flash_attention.cu), K6's two sweeps (the
same file) and K7 exp2's two sweeps a block (csrc/attn_diag_f32.cu).

The model repeats the kernel's fp32 sums but not the tensor core's order of
them: q2 = q * scale_log2 in fp32; every operand split into hi = x truncated
to tf32 and lo = x - hi, of which the tensor core reads the tf32 part
(truncated again here); each product as a_lo b_hi + a_hi b_lo + a_hi b_hi
(the lo*lo term dropped), every tf32 x tf32 term exact in fp32; one softmax
a kv tile of BN rows (64 at d = 16, 32 above) with the running max, the
ragged last tile masked; P V with the kernel's kv order within each group of
8 (P straight from S's accumulators: kv 0, 2, 4, 6, 1, 3, 5, 7); O
rescaled and summed a tile at a time; out = O / l, lse2 = m + log2(l).
K6 takes the max of every whole row from a first sweep of the same products
(the ragged tail masked), then P = exp2(s2 - m) with no rescale; K7 exp2
takes s = (q K^T) / sqrt(d) and commits max(m, the block's max) once a
block of block_k rows before the block's weights exp2((s - m) log2(e)).
Inputs come from numpy with a seed. The card's kernels are held to the plain
versions by chip_smoke.py at the same bound.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from audioldm_tpu.kernels.flash_attention import _flash_bh, _pad_reshape
from audioldm_tpu_torch.kernels import attn_diag as ad
from audioldm_tpu_torch.kernels import flash_attention as fa
from tools import bench_attn_diag as jax_diag

_PERM = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
jfa = importlib.import_module("audioldm_tpu.kernels.flash_attention")  # the module (the package exports its function)  # the kv row of A-fragment k within a group of 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these sizes gain nothing from a pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tf32(t):
    """``t`` with its 13 low mantissa bits cleared (tf32, toward zero)."""
    return (t.contiguous().view(torch.int32) & ~((1 << 13) - 1)).view(torch.float32)


def _split(x):
    """sm90.cuh's ``split`` as the tensor core reads it: (hi, lo) with hi =
    x truncated to tf32 and lo = x - hi, of which only the tf32 part counts."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _products(a, b, terms=("lh", "hl", "hh")):
    """``a @ b^T`` over the last dim as the kernel's tf32 products: the sum
    of the ``terms`` (a_lo b_hi, a_hi b_lo, a_hi b_hi), each exact in fp32,
    the small ones first as the kernel issues them."""
    ah, al = _split(a)
    bh, bl = _split(b)
    parts = {"lh": (al, bh), "hl": (ah, bl), "hh": (ah, bh)}
    out = None
    for t in terms:
        x, y = parts[t]
        p = torch.matmul(x, y.transpose(-1, -2))
        out = p if out is None else out + p
    return out


def kernel_model(q, k, v, scale_log2: float, terms=("lh", "hl", "hh")):
    """``(out, lse2)`` of ``flash_fwd_f32`` over fp32 ``[B, H, N, D]``."""
    d, m = q.shape[-1], k.shape[2]
    bn = 64 if d <= 16 else 32
    q2 = q * scale_log2
    pad = -m % bn  # the ragged last tile: zero rows (TMA's fill), their logits masked
    k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (k, v))
    rows = q.shape[:-1]
    mx = torch.full(rows, -math.inf)
    l = torch.zeros(rows)
    o = torch.zeros(q.shape)
    for t0 in range(0, m, bn):
        s = _products(q2, k[..., t0 : t0 + bn, :], terms)
        s[..., max(m - t0, 0) :] = -math.inf
        mn = torch.maximum(mx, s.amax(dim=-1))
        alpha = torch.exp2(mx - mn)
        p = torch.exp2(s - mn[..., None])
        l = l * alpha + p.sum(dim=-1)
        order = (torch.arange(0, bn, 8)[:, None] + _PERM).reshape(-1)
        vt = v[..., t0 : t0 + bn, :][..., order, :].transpose(-1, -2)  # V^T hi/lo planes, [d][kv]
        o = o * alpha[..., None] + _products(p[..., order], vt, terms)
        mx = mn
    return o / l[..., None], mx + torch.log2(l)


def _jax_flash(q, k, v):
    """The Pallas K3 (``_flash_bh``, interpret mode): out and lse2."""
    b, h, n, d = q.shape
    qp, kp, vp, (*_, dp) = _pad_reshape(*(jnp.asarray(a) for a in (q, k, v)))
    out, lse = _flash_bh(qp, kp, vp, interpret=True)
    return (np.asarray(out).reshape(b, h, n, dp)[..., :d], np.asarray(lse).reshape(b, h, n, -1)[..., 0])


@pytest.mark.parametrize("shape", [(1, 2, 256, 16), (1, 2, 200, 16), (1, 2, 256, 32), (1, 2, 160, 64)])
def test_kernel_arithmetic_meets_the_fp32_bound(shape):
    """The model of the 3xTF32 kernel against ``flash_plain`` (K1),
    ``flash_fwd_lse_plain`` (K3: out and lse2) and the JAX ``_flash_bh``:
    out and lse2 within 1e-5 max(1, max|ref|), the fp32 bound chip_smoke.py
    holds the card's kernel to. TF32 alone (the a_hi b_hi products only)
    misses it, so the bound catches a kernel that drops the lo products."""
    b, h, n, d = shape
    r = np.random.default_rng(7 * n + d)
    q, k, v = (r.standard_normal(shape).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    scale_log2 = fa._LOG2E / math.sqrt(d)
    out, lse2 = kernel_model(tq, tk, tv, scale_log2)
    q2 = fa.prescale(tq)
    torch.testing.assert_close(q2, tq * scale_log2, rtol=0, atol=0)  # K3's q2 is K1's product
    ref_out, ref_lse = fa.flash_fwd_lse_plain(q2, tk, tv)
    j_out, j_lse = _jax_flash(q, k, v)
    bound = lambda ref: 1e-5 * max(1.0, float(np.abs(np.asarray(ref)).max()))
    for want in (fa.flash_plain(tq, tk, tv).numpy(), ref_out.numpy(), j_out):
        np.testing.assert_allclose(out.numpy(), want, atol=bound(want), rtol=0)
    for want in (ref_lse.numpy(), j_lse):
        np.testing.assert_allclose(lse2.numpy(), want, atol=bound(want), rtol=0)
    tf32_out, _ = kernel_model(tq, tk, tv, scale_log2, terms=("hh",))
    assert np.abs(tf32_out.numpy() - ref_out.numpy()).max() > bound(ref_out)


def _tiles(k, v, bn):
    """k and v padded to whole tiles of bn kv rows (TMA's zero fill), and the
    kv order of P V within a tile (``_PERM`` in each group of 8)."""
    pad = -k.shape[2] % bn
    k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (k, v))
    return k, v, (torch.arange(0, bn, 8)[:, None] + _PERM).reshape(-1)


def one_model(q, k, v, scale_log2: float, terms=("lh", "hl", "hh")):
    """``out`` of the fp32 K6 over ``[B, H, N, D]``: sweep 1, the max of
    every whole row of S (the ragged tail left out); sweep 2, the same S
    again, P = exp2(s2 - m), l and O summed a tile at a time."""
    d, m = q.shape[-1], k.shape[2]
    bn = 64 if d <= 16 else 32
    q2 = q * scale_log2
    k, v, order = _tiles(k, v, bn)
    mx = torch.full(q.shape[:-1], -math.inf)
    for t0 in range(0, m, bn):  # sweep 1
        mx = torch.maximum(mx, _products(q2, k[..., t0 : t0 + bn, :], terms)[..., : m - t0].amax(dim=-1))
    l, o = torch.zeros(q.shape[:-1]), torch.zeros(q.shape)
    for t0 in range(0, m, bn):  # sweep 2
        s = _products(q2, k[..., t0 : t0 + bn, :], terms)
        s[..., max(m - t0, 0) :] = -math.inf
        p = torch.exp2(s - mx[..., None])
        l = l + p.sum(dim=-1)
        o = o + _products(p[..., order], v[..., t0 : t0 + bn, :][..., order, :].transpose(-1, -2), terms)
    return o / l[..., None]


def exp2_model(q, k, v, block_k: int, terms=("lh", "hl", "hh")):
    """``out`` of the fp32 K7 exp2 over ``[B, H, N, D]`` (N a multiple of
    block_k, block_k of the tile's bn): per block, sweep 1 for the row max
    of the raw S over the block's tiles, m = max(m, that max / sqrt(d)),
    then sweep 2 over its tiles with P = exp2((s - m) log2(e)), no rescale."""
    d, n = q.shape[-1], k.shape[2]
    bn = 64 if d <= 16 else 32
    assert block_k % bn == 0 and n % block_k == 0
    lscale = 1.0 / math.sqrt(d)
    _, _, order = _tiles(k, v, bn)
    m = torch.full(q.shape[:-1], -math.inf)
    l, o = torch.zeros(q.shape[:-1]), torch.zeros(q.shape)
    for b0 in range(0, n, block_k):
        bm = torch.full(q.shape[:-1], -math.inf)
        for t0 in range(b0, b0 + block_k, bn):
            bm = torch.maximum(bm, _products(q, k[..., t0 : t0 + bn, :], terms).amax(dim=-1))
        m = torch.maximum(m, bm * lscale)
        for t0 in range(b0, b0 + block_k, bn):
            s = _products(q, k[..., t0 : t0 + bn, :], terms) * lscale
            p = torch.exp2((s - m[..., None]) * ad.LOG2E)
            l = l + p.sum(dim=-1)
            o = o + _products(p[..., order], v[..., t0 : t0 + bn, :][..., order, :].transpose(-1, -2), terms)
    return o / torch.clamp(l, min=1e-20)[..., None]


def _jax_one_pass(q, k, v, monkeypatch):
    """The Pallas one-pass K6 (``_flash_bh(..., with_lse=False, sum_col=d)``,
    interpret mode; ``_ONE_PASS`` on for ``_pad_reshape``'s ones column)."""
    b, h, n, d = q.shape
    monkeypatch.setattr(jfa, "_ONE_PASS", True)
    qp, kp, vp, (*_, dp) = _pad_reshape(*(jnp.asarray(a) for a in (q, k, v)))
    out = _flash_bh(qp, kp, vp, interpret=True, with_lse=False, sum_col=d)
    return np.asarray(out).reshape(b, h, n, dp)[..., :d]


@pytest.mark.parametrize("shape", [(1, 2, 256, 16), (1, 2, 200, 16), (1, 2, 256, 32), (1, 2, 200, 32)])
def test_one_pass_sweeps_meet_the_fp32_bound(shape, monkeypatch):
    """The model of the fp32 K6's two sweeps against ``flash_one_plain``
    and the JAX one-pass kernel within 1e-5 max(1, max|ref|), at an even
    and a ragged kv length (200 is not a whole number of tiles at either
    head dim); TF32 alone misses the bound."""
    b, h, n, d = shape
    r = np.random.default_rng(11 * n + d)
    q, k, v = (r.standard_normal(shape).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    scale_log2 = fa._LOG2E / math.sqrt(d)
    out = one_model(tq, tk, tv, scale_log2)
    bound = lambda ref: 1e-5 * max(1.0, float(np.abs(np.asarray(ref)).max()))
    ref = fa.flash_one_plain(tq, tk, tv).numpy()
    for want in (ref, _jax_one_pass(q, k, v, monkeypatch)):
        np.testing.assert_allclose(out.numpy(), want, atol=bound(want), rtol=0)
    tf32 = one_model(tq, tk, tv, scale_log2, terms=("hh",))
    assert np.abs(tf32.numpy() - ref).max() > bound(ref)


@pytest.mark.parametrize("shape,block_k", [((1, 2, 256, 16), 128), ((1, 2, 192, 16), 64), ((1, 2, 256, 32), 128),
                                           ((1, 2, 192, 32), 64)])
def test_exp2_block_sweeps_meet_the_fp32_bound(shape, block_k):
    """The model of the fp32 K7 exp2 (two sweeps a block wider than a tile;
    at d = 16 a block of 64 rows is one tile) against ``diag_loop_plain``
    and the JAX tool's ``run(..., "exp2", ...)`` within 1e-5 max(1,
    max|ref|), at N a whole number of 128-row q tiles and not; TF32 alone
    misses the bound."""
    r = np.random.default_rng(13 * shape[2] + shape[3])
    q, k, v = (r.standard_normal(shape).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = exp2_model(tq, tk, tv, block_k)
    bound = lambda ref: 1e-5 * max(1.0, float(np.abs(np.asarray(ref)).max()))
    ref = ad.diag_loop_plain(tq, tk, tv, "exp2", block_k).numpy()
    with pltpu.force_tpu_interpret_mode():
        jax_ref = np.asarray(jax_diag.run(*(jnp.asarray(a) for a in (q, k, v)), "exp2", 64, block_k))
    for want in (ref, jax_ref):
        np.testing.assert_allclose(out.numpy(), want, atol=bound(want), rtol=0)
    tf32 = exp2_model(tq, tk, tv, block_k, terms=("hh",))
    assert np.abs(tf32.numpy() - ref).max() > bound(ref)


def test_logit_condition_covers_two_fp32_orders_of_large_logits():
    """The diagnostic checks' ragged fp32 input (``chip_smoke.py``
    ``diag_f32_inputs``: k[..., 0] + 32, every third q row's q[0] = -32, so
    those rows' base-2 logits lie near -370): the same softmax from two fp32
    evaluations of the logits, a sum in the order of d and the exact sum
    rounded once, differs by more than the fp32 bound 1e-5 max(1, max|ref|)
    on those rows, and by under it once each row's error is divided by its
    ``attn_diag.logit_condition`` (8 there, 1 on every other row). The
    tensor cores' order is a third order of the same sum."""
    r = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(r.standard_normal((1, 2, 256, 16)).astype(np.float32)) for _ in range(3))
    k[..., 0] += 32
    q[:, :, ::3, 0] = -32
    q2 = q * (ad.LOG2E / 4)
    in_order = torch.zeros(1, 2, 256, 256)
    for d in range(16):
        in_order = in_order + q2[..., d : d + 1] * k[..., d].unsqueeze(-2)
    rounded = torch.matmul(q2.double(), k.double().transpose(-1, -2)).float()

    def softmax_out(s):
        s = s.double()
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        return torch.matmul(p, v.double()) / p.sum(dim=-1, keepdim=True)

    a, b = softmax_out(in_order), softmax_out(rounded)
    bound = 1e-5 * max(1.0, b.abs().max().item())
    cond = ad.logit_condition(q, k, ad.LOG2E / 4)
    assert (a - b).abs().max().item() > bound
    assert ((a - b).abs() / cond).max().item() <= bound
    assert (cond[..., ::3, :] == 8).all() and (cond[..., 1::3, :] == 1).all() and (cond[..., 2::3, :] == 1).all()
