"""The arithmetic of the fp32 K4 and K5 (csrc/flash_attention_bwd.cu
``flash_bwd_dkv_f32`` and ``flash_bwd_dq_f32``: 3xTF32 on wgmma) modelled in
plain PyTorch on the CPU, against the port's plain backward and the JAX
package's Pallas kernels in interpret mode.

The model repeats the kernels' fp32 sums but not the tensor core's order of
them: every operand split into hi = x truncated to tf32 and lo = x - hi, of
which the tensor core reads the tf32 part (truncated again here); each
product as a_lo b_hi + a_hi b_lo + a_hi b_hi (the lo*lo term dropped), every
tf32 x tf32 term exact in fp32. The streamed side comes in tiles of the
kernels' widths (K4 q tiles, K5 kv tiles: 64 rows at d = 16, 32 at d = 32,
16 above); the ragged last tile is the whole tile that ends at the
last row, with the columns the previous tile covered masked to P = dS = 0.
Each tile's dV, dK or dQ is a fresh sum, added to the running fp32 sum,
of two operands built through the kernels' own index maps: A (P^T, dS^T or
dS) as ``frags`` takes it from the accumulator's elements, B as the
transform warps write the transposed planes, the streamed rows permuted
within each group of 8 (0, 2, 4, 6, 1, 3, 5, 7); a plane in row order
misses the bound. K4 multiplies dK by 1/(scale log2(e)) at the store. Inputs come from numpy with
a seed. The card's kernels are held to the plain version by chip_smoke.py at
the same bound.
"""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioldm_tpu.kernels.flash_attention import _LANE, _flash_bwd_bh
from audioldm_tpu_torch.kernels import flash_attention as fa


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
    """``a @ b^T`` over the last dim as the kernels' tf32 products: the sum
    of the ``terms`` (a_lo b_hi, a_hi b_lo, a_hi b_hi), each exact in fp32,
    the small ones first as the kernels issue them."""
    ah, al = _split(a)
    bh, bl = _split(b)
    parts = {"lh": (al, bh), "hl": (ah, bl), "hh": (ah, bh)}
    out = None
    for t in terms:
        x, y = parts[t]
        p = torch.matmul(x, y.transpose(-1, -2))
        out = p if out is None else out + p
    return out


def tile_rows(d: int) -> int:
    """The streamed rows a tile of K4 or K5 at head dim ``d``."""
    return 64 if d <= 16 else 32 if d <= 32 else 16


def frag_columns(t_rows: int):
    """The tile column that k of the A operand (P^T, dS^T or dS) holds, as
    ``frags`` fills the fragments: accumulator element 4 j + i of thread
    (g, tg), at row g + 8 ((i >> 1) & 1) and column 8 j + 2 tg + (i & 1),
    goes to fragment [j][i with 1 and 2 swapped], which wgmma reads as row
    g + 8 (f & 1) and k = 8 j + tg + 4 (f >> 1)."""
    cols = [None] * t_rows
    for j, tg, i in itertools.product(range(t_rows // 8), range(4), range(4)):
        f = (0, 2, 1, 3)[i]
        assert (i >> 1) & 1 == f & 1  # the fragment keeps the element's row
        cols[8 * j + tg + 4 * (f >> 1)] = 8 * j + 2 * tg + (i & 1)
    return torch.tensor(cols)


def plane_rows(t_rows: int):
    """The streamed row at each k of a transposed plane, as the transform
    warps write it: rows 8 j + par + 2 m (m < 4) of a 4 x 4 block go to
    k = 8 j + 4 par + m."""
    rows = [None] * t_rows
    for j, par, m in itertools.product(range(t_rows // 8), range(2), range(4)):
        rows[8 * j + 4 * par + m] = 8 * j + par + 2 * m
    return torch.tensor(rows)


def _fresh_sum(acc, streamed, terms, planes):
    """A tile's fresh sum ``acc @ streamed`` as the kernels take it: A from
    the accumulator through ``frag_columns``, B from the transposed planes
    through ``planes`` (``plane_rows``, or another order to show it fails)."""
    t_rows = acc.shape[-1]
    return _products(acc[..., frag_columns(t_rows)], streamed[..., planes(t_rows), :].transpose(-1, -2), terms)


def _tiles(t_rows: int, ns: int):
    """(start, lo, hi) of each streamed tile: its first row and the tile
    columns to keep; the ragged last tile ends at row ``ns``."""
    for i in range(-(-ns // t_rows)):
        s0 = min(i * t_rows, max(ns - t_rows, 0))
        yield s0, i * t_rows - s0, ns - s0


def _rows(x, s0, t_rows):
    """Rows [s0, s0 + t_rows) of the last-but-one axis, zero past the end
    (TMA's fill)."""
    x = x[..., s0 : s0 + t_rows, :]
    return torch.nn.functional.pad(x, (0, 0, 0, t_rows - x.shape[-2]))


def _grads(s, dp, lse2, delta, scale, lo, hi):
    """P and dS of a tile with lse2 and delta broadcast as given; the tile
    columns outside [lo, hi) masked to 0."""
    p = torch.exp2(s - lse2)
    ds = p * (dp - delta) * scale
    keep = (torch.arange(s.shape[-1]) >= lo) & (torch.arange(s.shape[-1]) < hi)
    return p * keep, ds * keep


def dkv_model(q2, k, v, dout, lse2, delta, scale, terms=("lh", "hl", "hh"), planes=plane_rows):
    """``(dk, dv)`` of ``flash_bwd_dkv_f32``: K4 owns the kv rows and streams
    q2, dO, lse2 and delta in q tiles."""
    t_rows = tile_rows(q2.shape[-1])
    vecs = torch.stack((lse2, delta), dim=-1)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for s0, lo, hi in _tiles(t_rows, q2.shape[2]):
        qt, ot, vt = (_rows(x, s0, t_rows) for x in (q2, dout, vecs))
        st = _products(k, qt, terms)  # S^T = K q2^T, [M, t]
        dpt = _products(v, ot, terms)
        p, ds = _grads(st, dpt, vt[..., None, :, 0], vt[..., None, :, 1], scale, lo, hi)
        dv = dv + _fresh_sum(p, ot, terms, planes)
        dk = dk + _fresh_sum(ds, qt, terms, planes)
    return dk * (1.0 / (scale * fa._LOG2E)), dv


def dq_model(q2, k, v, dout, lse2, delta, scale, terms=("lh", "hl", "hh"), planes=plane_rows):
    """``dq`` of ``flash_bwd_dq_f32``: K5 owns the q rows (lse2 and delta by
    row) and streams K and V in kv tiles."""
    t_rows = tile_rows(q2.shape[-1])
    dq = torch.zeros(q2.shape)
    for s0, lo, hi in _tiles(t_rows, k.shape[2]):
        kt, vt = _rows(k, s0, t_rows), _rows(v, s0, t_rows)
        s, dp = _products(q2, kt, terms), _products(dout, vt, terms)
        _, ds = _grads(s, dp, lse2[..., None], delta[..., None], scale, lo, hi)
        dq = dq + _fresh_sum(ds, kt, terms, planes)
    return dq


def _jax_bwd(q2, k, v, out, lse2, dout, scale):
    """The Pallas K4 and K5 (``_flash_bwd_bh``, interpret mode) on the same
    q2, out and lse2: ``(dq, dk, dv)``."""
    b, h, n, d = q2.shape
    dp = d + (-d) % _LANE
    pad = lambda x: jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, 0), (0, dp - d))).reshape(b * h, -1, dp)
    lse = jnp.broadcast_to(jnp.asarray(lse2).reshape(b * h, n, 1), (b * h, n, _LANE))
    grads = _flash_bwd_bh(pad(q2), pad(k), pad(v), pad(out), lse, pad(dout), scale, True)
    return [np.asarray(g).reshape(b, h, -1, dp)[..., :d] for g in grads]


@pytest.mark.parametrize("shape", [(1, 2, 256, 16), (1, 2, 200, 16), (1, 2, 136, 32), (1, 1, 72, 64)])
def test_kernel_arithmetic_meets_the_fp32_bound(shape):
    """The model of the 3xTF32 K4 and K5 against ``flash_bwd_plain`` and the
    JAX ``_flash_bwd_bh`` on the same q2, out and lse2 (the plain forward's):
    dq, dk and dv within 1e-5 max(1, max|ref|), the fp32 bound chip_smoke.py
    holds the card's kernels to, at an even and a ragged length and at the
    kernels' other tile widths. TF32 alone (the a_hi b_hi products only)
    misses it, so the bound catches a kernel that drops the lo products."""
    b, h, n, d = shape
    r = np.random.default_rng(11 * n + d)
    q, k, v, g = (r.standard_normal(shape).astype(np.float32) for _ in range(4))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    scale = 1.0 / math.sqrt(d)
    q2 = fa.prescale(tq)
    out, lse2 = fa.flash_fwd_lse_plain(q2, tk, tv)
    delta = (tg * out).sum(dim=-1)
    model = lambda terms: (dq_model(q2, tk, tv, tg, lse2, delta, scale, terms),
                           *dkv_model(q2, tk, tv, tg, lse2, delta, scale, terms))
    got = model(("lh", "hl", "hh"))
    plain = fa.flash_bwd_plain(q2, tk, tv, out, lse2, tg, scale)
    jax_ref = _jax_bwd(q2.numpy(), k, v, out.numpy(), lse2.numpy(), g, scale)
    bound = lambda ref: 1e-5 * max(1.0, float(np.abs(np.asarray(ref)).max()))
    for name, a, p, j in zip(("dq", "dk", "dv"), got, plain, jax_ref):
        for want in (p.numpy(), j):
            np.testing.assert_allclose(a.numpy(), want, atol=bound(want), rtol=0, err_msg=name)
    for name, a, p in zip(("dq", "dk", "dv"), model(("hh",)), plain):
        assert np.abs(a.numpy() - p.numpy()).max() > bound(p), name


def test_ragged_tile_masks_the_columns_the_previous_tile_covered():
    """At a ragged length the last tile overlaps the one before it: without
    the mask those rows would count twice, and the model would miss the
    plain backward by far more than the bound."""
    b, h, n, d = 1, 1, 100, 16
    r = np.random.default_rng(5)
    tq, tk, tv, tg = (torch.from_numpy(r.standard_normal((b, h, n, d)).astype(np.float32)) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    q2 = fa.prescale(tq)
    out, lse2 = fa.flash_fwd_lse_plain(q2, tk, tv)
    delta = (tg * out).sum(dim=-1)
    starts = [s0 for s0, _, _ in _tiles(tile_rows(d), n)]
    assert starts == [0, 36]  # the ragged tile repeats rows 36..63
    _, _, ref_dv = fa.flash_bwd_plain(q2, tk, tv, out, lse2, tg, scale)
    _, dv = dkv_model(q2, tk, tv, tg, lse2, delta, scale)
    assert (dv - ref_dv).abs().max() <= 1e-5 * max(1.0, ref_dv.abs().max().item())
    unmasked = _tiles
    try:
        globals()["_tiles"] = lambda t_rows, ns: ((s0, 0, hi) for s0, _, hi in unmasked(t_rows, ns))
        _, dv_twice = dkv_model(q2, tk, tv, tg, lse2, delta, scale)
    finally:
        globals()["_tiles"] = unmasked
    assert (dv_twice - ref_dv).abs().max() > 100 * 1e-5 * max(1.0, ref_dv.abs().max().item())


@pytest.mark.parametrize("d", [16, 32])
def test_transposed_planes_in_row_order_miss_the_bound(d):
    """The A fragments hold the tile's columns in the order 0, 2, 4, 6, 1,
    3, 5, 7 of each group of 8, so the transposed planes must hold the
    streamed rows in that order too: written in row order, dq, dk and dv
    miss the plain backward by far more than the bound."""
    b, h, n = 1, 1, 2 * tile_rows(d)
    r = np.random.default_rng(3 + d)
    tq, tk, tv, tg = (torch.from_numpy(r.standard_normal((b, h, n, d)).astype(np.float32)) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    q2 = fa.prescale(tq)
    out, lse2 = fa.flash_fwd_lse_plain(q2, tk, tv)
    delta = (tg * out).sum(dim=-1)
    assert torch.equal(frag_columns(tile_rows(d)), plane_rows(tile_rows(d)))
    plain = fa.flash_bwd_plain(q2, tk, tv, out, lse2, tg, scale)
    for planes, close in ((plane_rows, True), (torch.arange, False)):
        got = (dq_model(q2, tk, tv, tg, lse2, delta, scale, planes=planes),
               *dkv_model(q2, tk, tv, tg, lse2, delta, scale, planes=planes))
        for name, a, p in zip(("dq", "dk", "dv"), got, plain):
            bound = 1e-5 * max(1.0, p.abs().max().item())
            assert ((a - p).abs().max().item() <= bound) == close, (name, planes)
            if not close:
                assert (a - p).abs().max().item() > 100 * bound, name
