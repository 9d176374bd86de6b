"""The arithmetic of the fp32 K1 and K3 (csrc/flash_attention.cu
``flash_fwd_f32``: 3xTF32 on wgmma) modelled in plain PyTorch on the CPU,
against the port's plain versions and the JAX package's Pallas kernel in
interpret mode.

The model repeats the kernel's fp32 sums but not the tensor core's order of
them: q2 = q * scale_log2 in fp32; every operand split into hi = x truncated
to tf32 and lo = x - hi, of which the tensor core reads the tf32 part
(truncated again here); each product as a_lo b_hi + a_hi b_lo + a_hi b_hi
(the lo*lo term dropped), every tf32 x tf32 term exact in fp32; one softmax
a kv tile of BN rows (64 at d = 16, 32 above) with the running max, the
ragged last tile masked; P V with the kernel's kv order within each group of
8 (P straight from S's accumulators: kv 0, 2, 4, 6, 1, 3, 5, 7); O
rescaled and summed a tile at a time; out = O / l, lse2 = m + log2(l).
Inputs come from numpy with a seed. The card's kernel is held to the plain
versions by chip_smoke.py at the same bound.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioldm_tpu.kernels.flash_attention import _flash_bh, _pad_reshape
from audioldm_tpu_torch.kernels import flash_attention as fa

_PERM = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])  # the kv row of A-fragment k within a group of 8


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
