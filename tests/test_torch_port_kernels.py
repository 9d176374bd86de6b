"""The port's kernel modules (audioldm_tpu_torch/kernels) against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

On a CPU tensor each wrapper computes its plain PyTorch version, which is
what these tests hold against the Pallas kernel; the CUDA kernels themselves
are held against the same plain versions on the card by chip_smoke.py.
Inputs are made with numpy from a seed and handed to both packages.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioldm_tpu.kernels import mrf_conv as jax_mrf
from audioldm_tpu.kernels.flash_attention import _flash_bh, _flash_bwd_bh, _pad_reshape
from audioldm_tpu.kernels.flash_attention import flash_attention as jax_flash
from audioldm_tpu.kernels.flash_attention import supported as jax_flash_supported
from audioldm_tpu.models import vocoder as jax_vocoder
from audioldm_tpu.models.nn import sdpa as jax_sdpa
from audioldm_tpu_torch.kernels import flash_attention as fa
from audioldm_tpu_torch.kernels import mrf_conv
from audioldm_tpu_torch.models.vocoder import HifiGanResidualBlock

KS, DILS = (3, 7, 11), ((1, 3, 5),) * 3


def _qkv(shape, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(1, 2, 520, 16), (1, 2, 520, 40), (2, 1, 256, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas(shape, dtype):
    """fp32: 1e-5; bf16: 2e-2, the bound that also holds the JAX sdpa (it
    rounds the normalised weights to bf16, the kernels the unnormalised P).
    Against the Pallas kernel alone ``test_flash_plain_has_k1_arithmetic_of_pallas``
    holds a bound 8x tighter."""
    q, k, v = _qkv(shape, 0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    ref = np.asarray(jax_flash(jq, jk, jv, interpret=True).astype(jnp.float32))
    ref_sdpa = np.asarray(jax_sdpa(jq, jk, jv).astype(jnp.float32))
    before = dict(fa.flash_attention.launches)
    out = fa.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v))).float().numpy()
    assert dict(fa.flash_attention.launches) == before  # CPU tensors never launch
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)
    np.testing.assert_allclose(out, ref_sdpa, atol=tol, rtol=tol)


def _k1_k6_tolerance(dtype, ref):
    """fp32: 2e-6 (the same terms summed in another order; ~2e-7 seen).
    bf16: one bf16 ulp of the largest output, 2^-8 max|ref|: both sides
    round q2 = q * log2(e)/sqrt(d) to bf16, exponentiate against the whole
    row's max and round P to bf16 alike, so what is left is fp32 sums in
    another order, which can move an output across one rounding boundary."""
    return 2e-6 if dtype == "float32" else 2.0**-8 * float(np.abs(ref).max())


@pytest.mark.parametrize("d", [16, 32, 40])
@pytest.mark.parametrize("n", [256, 250])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_has_k1_arithmetic_of_pallas(dtype, n, d):
    """``flash_plain`` (K1's plain version, what ``flash_attention`` computes
    on CPU tensors) against the Pallas K1 ``_flash_kernel_nolse`` in
    interpret mode, at an aligned and a ragged length and three head dims
    (40 is padded by both). Bound: ``_k1_k6_tolerance``."""
    q, k, v = _qkv((1, 2, n, d), 100 * n + d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jax_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)), interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    out = fa.flash_plain(tq, tk, tv)
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), ref, atol=_k1_k6_tolerance(dtype, ref), rtol=0)
    torch.testing.assert_close(fa.flash_attention(tq, tk, tv), out, rtol=0, atol=0)


@pytest.mark.parametrize("d", [16, 32, 40])
@pytest.mark.parametrize("n", [256, 250])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_one_plain_has_k6_arithmetic_of_pallas(dtype, n, d, jax_one_pass):
    """``flash_one_plain`` (K6's plain version) against the Pallas one-pass
    kernel ``_flash_kernel_one`` in interpret mode, at an aligned and a
    ragged length and three head dims. Bound: ``_k1_k6_tolerance``."""
    q, k, v = _qkv((1, 2, n, d), 100 * n + d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jax_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)), interpret=True).astype(jnp.float32))
    assert jax_one_pass == [n if n % 8 else None]
    out = fa.flash_one_plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    np.testing.assert_allclose(out.float().numpy(), ref, atol=_k1_k6_tolerance(dtype, ref), rtol=0)


def test_prescale_rounds_q_as_the_jax_wrapper_does():
    """``prescale`` is ``_pad_reshape``'s q2 (without its lane padding):
    the fp32 product with ``(1/sqrt(d)) * log2(e)``, rounded to q's dtype."""
    for d, dtype in ((16, "bfloat16"), (40, "bfloat16"), (32, "float32")):
        q = _qkv((1, 2, 24, d), d)[0]
        jq = jnp.asarray(q, getattr(jnp, dtype))
        q2 = np.asarray(_pad_reshape(jq, jq, jq)[0].astype(jnp.float32)).reshape(1, 2, 24, -1)[..., :d]
        got = fa.prescale(torch.from_numpy(q).to(getattr(torch, dtype))).float().numpy()
        np.testing.assert_array_equal(got, q2)


@pytest.mark.parametrize("d", [16, 32, 40])
@pytest.mark.parametrize("n", [256, 250])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_train_plain_matches_pallas(n, dtype, d):
    """The plain versions of K3 (out, lse2) and of K4 + K5 (dq, dk, dv)
    against the Pallas forward-with-lse and backward kernels in interpret
    mode, at an aligned and a ragged length and three head dims (40 is
    padded by both: the JAX wrapper to its lanes, the CUDA kernels to 64
    columns). Both sides compute from the same ``q2 = prescale(q)``
    (rounded to bf16 in bf16) and round P and dS at the same places, and K4's ``1/(scale log2(e))`` multiplies the fp32
    ``dS^T q2`` on both. fp32: 2e-5 forward (lse2 2e-5), 5e-5 backward, the
    JAX package's own bounds for these kernels (fp32 q2 is not rounded:
    only the order of the sums differs). bf16: out and every gradient
    2^-8 max|ref| (one bf16 ulp of the largest entry: fp32 sums in another
    order can move an entry across one rounding boundary; ~8e-4 max|ref|
    seen), lse2 1e-5 (fp32 sums of the same terms; about one fp32 ulp of
    a lse2 near 8 seen)."""
    b, h = 1, 2
    r = np.random.default_rng(n if d == 16 else 100 * n + d)
    q, k, v, g = (r.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(4))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    qp, kp, vp, (_, _, _, _, _, dp) = _pad_reshape(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    out_bh, lse = _flash_bh(qp, kp, vp, interpret=True)
    do = jnp.pad(jnp.asarray(g, jdt), ((0, 0), (0, 0), (0, 0), (0, dp - d))).reshape(b * h, n, dp)
    ref = [np.asarray(t.astype(jnp.float32)).reshape(b, h, n, dp)[..., :d]
           for t in (out_bh, *_flash_bwd_bh(qp, kp, vp, out_bh, lse, do, 1.0 / math.sqrt(d), True))]
    ref_lse = np.asarray(lse).reshape(b, h, n, -1)[..., 0]

    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, g))
    q2 = fa.prescale(tq)
    out, lse2 = fa.flash_fwd_lse_plain(q2, tk, tv)
    grads = fa.flash_bwd_plain(q2, tk, tv, out, lse2, tg)
    if dtype == "float32":
        tols = [2e-5, 5e-5, 5e-5, 5e-5]
        lse_tol = 2e-5
    else:
        tols = [2.0**-8 * float(np.abs(want).max()) for want in ref]
        lse_tol = 1e-5
    np.testing.assert_allclose(out.float().numpy(), ref[0], atol=tols[0], rtol=0)
    np.testing.assert_allclose(lse2.numpy(), ref_lse, atol=lse_tol, rtol=0)
    for got, want, tol in zip(grads, ref[1:], tols[1:]):
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_flash_function_matches_autograd_through_plain_attention(dtype, tol):
    """The autograd Function on CPU tensors (plain forward-with-lse, plain
    backward) against autograd through ``sdpa_plain``: strided head views of
    [B, N, C] projections, a ragged length, a head dim that is not a
    multiple of 8, and a non-contiguous dO. fp32 2e-5; bf16 3e-2 (P and dS
    are rounded to bf16 before their products, autograd rounds the
    normalised weights)."""
    tdt = getattr(torch, dtype)
    b, n, h, d = 2, 250, 3, 20
    gen = torch.Generator().manual_seed(0)
    leaves = [torch.randn(b, n, h * d, generator=gen).to(tdt).requires_grad_() for _ in range(3)]
    q, k, v = (t.view(b, n, h, d).transpose(1, 2) for t in leaves)
    dout = torch.randn(b, d, n, h, generator=gen).to(tdt).permute(0, 3, 2, 1)
    assert not dout.is_contiguous()
    before = dict(fa.flash_fwd_lse.launches)
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn is not None and type(out.grad_fn).__name__.startswith("_FlashFunction")
    got = torch.autograd.grad(out, leaves, dout)
    ref_out = fa.sdpa_plain(q, k, v)
    want = torch.autograd.grad(ref_out, leaves, dout)
    assert dict(fa.flash_fwd_lse.launches) == before  # CPU tensors never launch
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=0)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), atol=tol, rtol=0)
    with torch.no_grad():  # without grad: the inference path, no graph
        assert fa.flash_attention(q, k, v).grad_fn is None


def test_flash_function_under_checkpoint():
    """Rematerialisation recomputes the Function's forward: same gradients."""
    from torch.utils.checkpoint import checkpoint

    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 2, 64, 8, generator=gen).requires_grad_() for _ in range(3))
    plain = torch.autograd.grad(fa.flash_attention(q, k, v).square().sum(), (q, k, v))
    remat = torch.autograd.grad(checkpoint(fa.flash_attention, q, k, v, use_reentrant=False).square().sum(), (q, k, v))
    for a, w in zip(remat, plain):
        torch.testing.assert_close(a, w, atol=1e-6, rtol=0)


def test_launch_counts_names_every_kernel():
    from audioldm_tpu_torch import kernels

    assert set(kernels.launch_counts()) == {
        "flash_fwd", "flash_fwd_one", "flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq", "mrf_stage",
        "diag_loop", "fori_exp2", "grid3", "grid3b"}
    fa.flash_bwd_dq.launches[("float32", (1, 1, 8, 8))] += 1
    assert kernels.launch_counts()["flash_bwd_dq"] == {("float32", (1, 1, 8, 8)): 1}
    kernels.attn_diag.diag_loop.launches[("bfloat16", (1, 1, 64, 16), "exp2", 64)] += 1
    kernels.attn_diag.grid3b.launches[("bfloat16", (1, 1, 64, 16))] += 1
    assert kernels.launch_counts()["diag_loop"] == {("bfloat16", (1, 1, 64, 16), "exp2", 64): 1}
    assert kernels.launch_counts()["grid3b"] == {("bfloat16", (1, 1, 64, 16)): 1}
    kernels.reset_launches()
    assert not any(kernels.launch_counts().values())


def test_flash_wrapper_refuses_other_devices():
    q = torch.empty((1, 1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("n,m,d", [(4096, 4096, 16), (4000, 4000, 16), (2048, 2048, 128), (1024, 1024, 32), (4096, 4096, 160)])
def test_flash_routing_rule_matches_jax(n, m, d):
    assert fa.supported(n, m, d) == jax_flash_supported(n, m, d)


@pytest.mark.parametrize("device,n,d,masked,want", [
    ("cuda", 4096, 16, False, True),  # level 0 of a 10.24 s clip
    ("cuda", 1024, 32, False, True),  # level 1
    ("cuda", 256, 48, False, True),  # level 2, at the card's threshold (PERF.md's kernel table)
    ("cuda", 252, 48, False, False),  # level 2 of a 10.0 s clip, under it
    ("cuda", 64, 80, False, False),  # the mid block
    ("cuda", 4096, 160, False, False),  # a head dim above the kernels' 128
    ("cuda", 4096, 16, True, False),  # masked
    ("cpu", 4096, 16, False, True),  # CPU tensors: the JAX rule
    ("cpu", 1024, 32, False, False),
    ("cpu", 2048, 32, False, True),
    ("cpu", 4096, 16, True, False),
])
def test_card_routing_rule(device, n, d, masked, want):
    """``routes`` on a device object (no card needed to ask it): on CUDA the
    card's threshold, on the CPU the JAX rule, never a masked call; a
    threshold above every level (``set_min_tokens(8192)``) turns both off,
    and ``min_tokens`` restores both thresholds."""
    dev = torch.device(device)
    assert fa.routes(dev, n, n, d, masked) == want
    if device == "cpu" and not masked:
        assert want == jax_flash_supported(n, n, d)
    saved = fa._MIN_TOKENS, fa._CARD_MIN_TOKENS
    with fa.min_tokens(8192):
        assert not fa.routes(dev, n, n, d, masked)
    assert (fa._MIN_TOKENS, fa._CARD_MIN_TOKENS) == saved == (2048, 256)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_sdpa_level1_call_on_the_flash_route_matches_sdpa_plain(dtype, tol, monkeypatch):
    """A level-1-shaped call (``[1, 2, 1024, 32]``, head views of [B, N, C]
    projections) through ``models/nn.py sdpa`` with the threshold at 1024,
    so that it takes the flash route (on CPU tensors the plain versions of
    K3-K5 inside the autograd Function), against ``sdpa_plain``: the output
    and the gradients of q, k and v, at the Function's tolerances above. One
    token more on the threshold and the same call takes ``sdpa_plain``."""
    from audioldm_tpu_torch.models import nn as port_nn

    tdt = getattr(torch, dtype)
    b, n, h, d = 1, 1024, 2, 32
    gen = torch.Generator().manual_seed(3)
    leaves = [torch.randn(b, n, h * d, generator=gen).to(tdt).requires_grad_() for _ in range(3)]
    q, k, v = (t.view(b, n, h, d).transpose(1, 2) for t in leaves)
    dout = torch.randn(b, h, n, d, generator=gen).to(tdt)
    calls, real = [], fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention", lambda *a: calls.append(tuple(a[0].shape)) or real(*a))
    with fa.min_tokens(1024):
        out = port_nn.sdpa(q, k, v)
    assert calls == [(b, h, n, d)] and type(out.grad_fn).__name__.startswith("_FlashFunction")
    got = torch.autograd.grad(out, leaves, dout)
    ref = fa.sdpa_plain(q, k, v)
    want = torch.autograd.grad(ref, leaves, dout)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), atol=tol, rtol=0)
    with fa.min_tokens(1025):
        torch.testing.assert_close(port_nn.sdpa(q, k, v), ref, atol=0, rtol=0)
    assert len(calls) == 1


@pytest.fixture
def jax_one_pass(monkeypatch):
    """The JAX package with ``_ONE_PASS`` on; yields the list of calls that
    reached its one-pass Pallas kernel (one entry per trace of it)."""
    jfa = importlib.import_module("audioldm_tpu.kernels.flash_attention")
    traced = []
    kernel = jfa._flash_kernel_one

    def spy(*a, **k):
        traced.append(k.get("m_real"))
        return kernel(*a, **k)

    monkeypatch.setattr(jfa, "_ONE_PASS", True)
    monkeypatch.setattr(jfa, "_flash_kernel_one", spy)
    return traced


@pytest.mark.parametrize("dtype,n,tol", [("float32", 256, 2e-5), ("float32", 250, 2e-5), ("bfloat16", 512, 2e-2)])
def test_flash_one_plain_matches_pallas_one_pass(dtype, n, tol, jax_one_pass, monkeypatch):
    """``flash_one_plain`` (and ``flash_attention`` on CPU tensors with the
    flag on) against the Pallas one-pass kernel in interpret mode, aligned
    and ragged, and against ``sdpa_plain``. fp32: 2e-5. bf16: 2e-2, the JAX
    package's own bound for this kernel, which also holds ``sdpa_plain``
    (fp32 logits of the unrounded q, the normalised weights rounded); the
    bound against the Pallas kernel alone is
    ``test_flash_one_plain_has_k6_arithmetic_of_pallas``'s."""
    q, k, v = _qkv((1, 2, n, 16), n)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jax_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)), interpret=True).astype(jnp.float32))
    assert jax_one_pass == [n if n % 8 else None]  # the one-pass kernel ran, masked where ragged
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    out = fa.flash_one_plain(tq, tk, tv)
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=tol)
    np.testing.assert_allclose(out.float().numpy(), fa.sdpa_plain(tq, tk, tv).float().numpy(), atol=tol, rtol=tol)
    monkeypatch.setattr(fa, "_ONE_PASS", True)
    before = dict(fa.flash_attention.launches_one)
    torch.testing.assert_close(fa.flash_attention(tq, tk, tv), out, rtol=0, atol=0)
    assert dict(fa.flash_attention.launches_one) == before  # CPU tensors never launch


def test_flash_one_plain_denominator_is_the_sum_of_rounded_weights():
    """What sets K6 apart from K1: ``l`` sums the bf16-rounded ``P``, as the
    ones column of the second product does. In float64, from the same
    rounded weights: O / sum(P_rounded) reproduces the output to a bf16
    rounding (2^-8 relative), and with v = 1 everywhere every output is
    exactly ``l / l = 1``. The logits are those of q pre-scaled by
    log2(e)/sqrt(d) and rounded to bf16, as the kernel loads it."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv((1, 1, 64, 16), 3))
    assert torch.equal(fa.flash_one_plain(q, k, torch.ones_like(v)), torch.ones_like(v))
    s2 = (q.float() * (fa._LOG2E / 4.0)).bfloat16().float() @ k.float().transpose(-1, -2)
    p = torch.exp2(s2 - s2.amax(-1, keepdim=True)).bfloat16().double()
    want = (p @ v.double()) / p.sum(-1, keepdim=True)
    torch.testing.assert_close(fa.flash_one_plain(q, k, v).double(), want, rtol=2**-8, atol=1e-6)


@pytest.mark.parametrize("m,d,dtype,want", [
    (4096, 16, "bfloat16", True), (4097, 16, "bfloat16", False), (2048, 16, "float32", True),
    (2049, 16, "float32", False), (512, 120, "bfloat16", True), (512, 128, "bfloat16", False),
])
def test_one_pass_routing_matches_jax(m, d, dtype, want, jax_one_pass, monkeypatch):
    """With the flag on both packages send the same calls to the one-pass
    kernel: one kv block (4096 rows bf16, 2048 fp32) and a head dim below
    128. The JAX side is asked by running it (8 q rows, interpret mode)."""
    monkeypatch.setattr(fa, "_ONE_PASS", True)
    assert fa.one_pass_routes(m, d, getattr(torch, dtype)) is want
    r = np.random.default_rng(0)
    q = jnp.asarray(r.standard_normal((1, 1, 8, d)), getattr(jnp, dtype))
    kv = jnp.asarray(r.standard_normal((1, 1, m, d)), getattr(jnp, dtype))
    jax_flash(q, kv, kv, interpret=True)
    assert bool(jax_one_pass) is want


def test_one_pass_flag_is_off_by_default_and_never_takes_a_call_that_needs_grad(monkeypatch):
    assert fa.one_pass() is False and not fa.one_pass_routes(4096, 16, torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 64, 16, generator=gen) for _ in range(3))
    torch.testing.assert_close(fa.flash_attention(q, k, v), fa.flash_plain(q, k, v), rtol=0, atol=0)
    fa.set_one_pass(True)
    try:
        assert fa.one_pass() is True
        torch.testing.assert_close(fa.flash_attention(q, k, v), fa.flash_one_plain(q, k, v), rtol=0, atol=0)
        out = fa.flash_attention(q.requires_grad_(), k, v)  # the Function, K3-K5: K6's output would carry no graph
        assert type(out.grad_fn).__name__.startswith("_FlashFunction")
        with torch.no_grad():
            assert fa.flash_attention(q, k, v).grad_fn is None
        big = torch.zeros(1, 1, 4104, 8, dtype=torch.bfloat16)  # above the one-block bound: K1's arithmetic
        torch.testing.assert_close(fa.flash_attention(big[:, :, :8], big, big), fa.flash_plain(big[:, :, :8], big, big), rtol=0, atol=0)
    finally:
        fa.set_one_pass(False)


def _resblocks(c, seed):
    """Port resblocks and the same weights as JAX param dicts (WIO)."""
    gen = torch.Generator().manual_seed(seed)
    blocks = []
    for k, dils in zip(KS, DILS):
        blk = HifiGanResidualBlock(c, k, dils)
        with torch.no_grad():
            for p in blk.parameters():
                p.copy_(torch.rand(p.shape, generator=gen) * 0.4 - 0.2)
        blocks.append(blk)

    def conv(m):
        return {"kernel": jnp.asarray(m.weight.detach().numpy().transpose(2, 1, 0)), "bias": jnp.asarray(m.bias.detach().numpy())}

    jax_blocks = [
        {
            "convs1": {str(d): conv(b.convs1[d]) for d in range(len(b.convs1))},
            "convs2": {str(d): conv(b.convs2[d]) for d in range(len(b.convs2))},
        }
        for b in blocks
    ]
    return blocks, jax_blocks


@pytest.mark.parametrize("with_post", [False, True])
def test_mrf_plain_matches_pallas(with_post):
    """Ragged T (300 over 256-sample blocks) with signal-edge blocks; fp32,
    <= 1e-4 * max|ref|."""
    c, t = 32, 300
    blocks, jblocks = _resblocks(c, 1)
    x = np.random.default_rng(2).standard_normal((1, c, t)).astype(np.float32)
    post = jpost = None
    if with_post:
        post = torch.nn.Conv1d(c, 1, 7, padding=3)
        jpost = {"kernel": jnp.asarray(post.weight.detach().numpy().transpose(2, 1, 0)), "bias": jnp.asarray(post.bias.detach().numpy())}
    ref = np.asarray(
        jax_mrf._fused_mrf_stage_impl(
            jnp.asarray(x), jblocks, jpost, kernel_sizes=KS, dilations=DILS, slope=0.1,
            block_t=256, interpret=True, channel_major=True,
        )
    )
    before = dict(mrf_conv.mrf_stage.launches)
    with torch.no_grad():
        out = mrf_conv.mrf_stage(torch.from_numpy(x), blocks, KS, DILS, 0.1, post=post).numpy()
    assert dict(mrf_conv.mrf_stage.launches) == before
    assert out.shape == ref.shape == ((1, 1, t) if with_post else (1, c, t))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=1e-4 * scale, rtol=0)
    if not with_post:  # and the JAX package's plain resblock chain
        xt = jnp.asarray(x.transpose(0, 2, 1))
        acc = sum(jax_vocoder._apply_resblock(b, xt, k, d, 0.1) for b, k, d in zip(jblocks, KS, DILS)) / 3
        np.testing.assert_allclose(out, np.asarray(acc).transpose(0, 2, 1), atol=1e-4 * scale, rtol=0)


def test_mrf_wrapper_refuses_other_devices():
    blocks, _ = _resblocks(8, 0)
    x = torch.empty((1, 8, 300), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mrf_conv.mrf_stage(x, blocks, KS, DILS, 0.1)


@pytest.mark.parametrize("t,c", [(81936, 64), (163872, 32), (40968, 128), (255, 32), (256, 8)])
def test_mrf_routing_rule_matches_jax(t, c):
    assert mrf_conv.supported(t, c, torch.float32) == jax_mrf.supported(t, c, jnp.float32)
    assert not mrf_conv.supported(t, c, torch.bfloat16)


def test_mrf_topology_rule():
    # the audioldm-s resblocks plus the 7-tap conv_post fit the kernel's halo
    assert mrf_conv.receptive_halo(KS, DILS) == 60
    assert mrf_conv.topology_ok(KS, DILS, 7)
    assert not mrf_conv.topology_ok((11,), ((3, 5, 5),), 7)  # halo 80 > 64
    assert not mrf_conv.topology_ok((4,), ((1,),), 0)  # even kernels change the length
    assert not mrf_conv.topology_ok((5,), ((1,),), 0)  # no compiled tap loop
    assert not mrf_conv.topology_ok(KS + (3,), DILS + ((1,),), 0)  # more resblocks than compiled


def _unpack_planes(flat, k, cp):
    """``pack_planes``' output back to ``[k, 2, co, ci]`` (hi, lo)."""
    return flat.reshape(k, 2, cp // 8, cp // 4, 8, 4).permute(0, 1, 2, 4, 3, 5).reshape(k, 2, cp, cp)


def test_mrf_weight_packing_layout_and_cache():
    """The kernel's weight layout: per conv and tap a hi and a lo plane of
    the [co, ci] matrix in wgmma's K-major core-matrix order
    [co/8][ci/4][8][4], channels zero-padded to 16, 32 or 64; ``hi + lo``
    rebuilds every weight to 2^-22 of its magnitude, ``hi`` and ``lo`` have
    their 13 low mantissa bits zero (tf32); repacked only after a change."""
    c = 12
    cp = mrf_conv.kernel_channels(c)
    assert (cp, mrf_conv.kernel_channels(32), mrf_conv.kernel_channels(40)) == (16, 32, 64)
    blocks, _ = _resblocks(c, 3)
    w, b = mrf_conv._pack(blocks, DILS, c, cp, "cpu")
    assert w.numel() == sum(2 * len(d) * 2 * k * cp * cp for k, d in zip(KS, DILS)) and b.numel() == 18 * cp
    second = blocks[1].convs2[2]  # resblock 1 (k=7), unit 2, conv 2
    off = 2 * 3 * 2 * 3 * cp * cp + (2 * 2 + 1) * 2 * 7 * cp * cp
    planes = _unpack_planes(w[off : off + 2 * 7 * cp * cp], 7, cp)
    want = second.weight.detach().permute(2, 0, 1)  # [tap, co, ci]
    hi, lo = planes[:, 0], planes[:, 1]
    assert not planes[:, :, c:].any() and not planes[:, :, :, c:].any()
    rebuilt = (hi + lo)[:, :c, :c]
    assert ((rebuilt - want).abs() <= 2.0**-22 * want.abs()).all()
    assert not torch.equal(hi[:, :c, :c], want)  # the lo plane carries something
    for t in (hi, lo):
        assert not (t.view(torch.int32) & ((1 << 13) - 1)).any()
    torch.testing.assert_close(b[(3 * 2 + 2 * 2 + 1) * cp :][:c], second.bias.detach(), rtol=0, atol=0)
    again = mrf_conv._pack(blocks, DILS, c, cp, "cpu")
    assert again[0] is w and again[1] is b
    with torch.no_grad():
        second.weight.mul_(2.0)
    w2, _ = mrf_conv._pack(blocks, DILS, c, cp, "cpu")
    assert w2 is not w
    torch.testing.assert_close(w2[off : off + 2 * 7 * cp * cp], 2 * w[off : off + 2 * 7 * cp * cp], rtol=0, atol=0)


@pytest.mark.parametrize("change", [False, True])
def test_mrf_weight_packing_of_inference_mode_weights(change):
    """A vocoder made under ``torch.inference_mode()`` (as a loader may make
    it): its parameters have no version counter, and ``_pack`` packs its
    last stage's resblocks all the same; with ``change``, after a weight is
    doubled in place under inference mode, the next call's buffer still
    equals ``pack_planes`` of the current weights (no stale cache)."""
    from audioldm_tpu_torch.config import VocoderConfig
    from audioldm_tpu_torch.models.vocoder import SpeechT5HifiGan

    with torch.inference_mode():
        voc = SpeechT5HifiGan(VocoderConfig(upsample_initial_channel=64))
        nk = len(voc.cfg.resblock_kernel_sizes)
        blocks = list(voc.resblocks[-nk:])
        dils = voc.cfg.resblock_dilation_sizes
        c = blocks[0].convs1[0].weight.shape[0]
        cp = mrf_conv.kernel_channels(c)
        assert blocks[0].convs1[0].weight.is_inference()
        w, b = mrf_conv._pack(blocks, dils, c, cp, "cpu")
        if change:
            blocks[1].convs2[2].weight.mul_(2.0)
            w, b = mrf_conv._pack(blocks, dils, c, cp, "cpu")
        convs = [cv for blk, ds in zip(blocks, dils) for d in range(len(ds)) for cv in (blk.convs1[d], blk.convs2[d])]
        want = torch.cat([mrf_conv.pack_planes(cv.weight, cp) for cv in convs])
        want_b = torch.zeros((len(convs), cp))
        for i, cv in enumerate(convs):
            want_b[i, :c] = cv.bias
    assert torch.equal(w, want) and torch.equal(b, want_b.reshape(-1))


def test_split_tf32_rounds_to_nearest_ties_away():
    """``split_tf32``'s hi is ``cvt.rna.tf32.f32``: the nearest tf32 value,
    ties away from zero, signs kept; lo is the same rounding of the rest."""
    one_ulp = 2.0**-10  # of tf32 at 1.0
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 2 - 2.0**-23, 3.0e-3, -7.5])
    hi, lo = mrf_conv.split_tf32(x)
    assert hi.tolist() == [1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0, hi[4].item(), -7.5]
    assert abs(hi[4].item() - 3.0e-3) <= 2.0**-11 * 3.0e-3
    assert ((hi + lo - x).abs() <= 2.0**-22 * x.abs()).all()


def _truncate_tf32(t):
    """``t`` with its 13 low mantissa bits cleared (tf32, toward zero)."""
    return (t.contiguous().view(torch.int32) & ~((1 << 13) - 1)).view(torch.float32)


def _mrf_stage_tf32(x, blocks, kernel_sizes, dilations, slope, post, products):
    """The kernel's arithmetic on the CPU: every resblock conv as the sum of
    the tf32 products ``products`` names ("hh" = a_hi w_hi, "lh" = a_lo
    w_hi, "hl" = a_hi w_lo). The weights are split as the wrapper packs
    them (``split_tf32``); the activations as the kernel splits them: hi =
    x truncated to tf32, lo = x - hi, of which the tensor core reads the
    tf32 part (truncated here). Each product is exact in fp32 (11-bit
    significands) and summed in fp32; conv_post and the rest as in
    ``mrf_stage_plain``."""
    import torch.nn.functional as F

    def conv(a, m, dil, pad):
        ah = _truncate_tf32(a)
        al = _truncate_tf32(a - ah)
        wh, wl = mrf_conv.split_tf32(m.weight.detach())
        parts = {"hh": (ah, wh), "lh": (al, wh), "hl": (ah, wl)}
        out = sum(F.conv1d(parts[p][0], parts[p][1], padding=pad, dilation=dil) for p in products)
        return out + m.bias.detach()[:, None]

    acc = None
    for blk, k, dils in zip(blocks, kernel_sizes, dilations):
        r = x
        for d, dil in enumerate(dils):
            h = conv(F.leaky_relu(r, slope), blk.convs1[d], dil, (k * dil - dil) // 2)
            r = conv(F.leaky_relu(h, slope), blk.convs2[d], 1, (k - 1) // 2) + r
        acc = r if acc is None else acc + r
    out = acc / len(blocks)
    if post is not None:
        kp = post.weight.shape[-1]
        out = torch.tanh(F.conv1d(F.leaky_relu(out, 0.01), post.weight, post.bias, padding=(kp - 1) // 2))
    return out


@pytest.mark.parametrize("with_post", [False, True])
def test_mrf_3xtf32_chain_meets_the_fp32_bound_of_the_pallas_stage(with_post):
    """The kernel's 3xTF32 arithmetic (three tf32 products a term, the
    lo*lo one dropped), emulated in torch, against the JAX stage
    ``_fused_mrf_stage_impl`` (interpret mode) at ``test_mrf_plain_matches_pallas``'s
    shape: within 1e-4 max|ref|, the bound chip_smoke.py holds the card's
    kernel to (seen: 1.0e-6 without conv_post, 5.2e-6 with it). TF32 alone
    (the a_hi w_hi product only, ~2^-10 relative a term) misses that bound
    (seen: 1.8e-3 and 6.1e-3), so at this shape the bound alone catches a
    kernel that drops the lo products (fault_check's "lo products
    dropped"): asserted too."""
    c, t = 32, 300
    blocks, jblocks = _resblocks(c, 1)
    x = np.random.default_rng(2).standard_normal((1, c, t)).astype(np.float32)
    post = jpost = None
    if with_post:
        post = torch.nn.Conv1d(c, 1, 7, padding=3)
        jpost = {"kernel": jnp.asarray(post.weight.detach().numpy().transpose(2, 1, 0)), "bias": jnp.asarray(post.bias.detach().numpy())}
    ref = np.asarray(
        jax_mrf._fused_mrf_stage_impl(
            jnp.asarray(x), jblocks, jpost, kernel_sizes=KS, dilations=DILS, slope=0.1,
            block_t=256, interpret=True, channel_major=True,
        )
    )
    scale = np.abs(ref).max()
    with torch.no_grad():
        three = _mrf_stage_tf32(torch.from_numpy(x), blocks, KS, DILS, 0.1, post, ("hh", "lh", "hl")).numpy()
        one = _mrf_stage_tf32(torch.from_numpy(x), blocks, KS, DILS, 0.1, post, ("hh",)).numpy()
    err3, err1 = np.abs(three - ref).max() / scale, np.abs(one - ref).max() / scale
    print(f"mrf 3xTF32 max|d|/max|ref| {err3:.3g}, TF32 alone {err1:.3g} (bound 1e-4)")
    assert err3 <= 1e-4
    assert err1 > 1e-4


@pytest.mark.parametrize("with_post", [False, True])
def test_mrf_wrapper_hands_the_kernel_its_geometry(with_post):
    """What ``mrf_stage`` passes the C function for a CUDA tensor (the
    arguments as ``_stage_args`` builds them): the channel count padded to
    16/32/64, the kernel sizes and dilations, the halo (receptive field 60, + 3 for a
    7-tap conv_post), the packed hi/lo planes of every conv, and an output
    of [B, 1, T] with conv_post, [B, C, T] without."""
    c, t = 24, 300
    blocks, _ = _resblocks(c, 4)
    post = torch.nn.Conv1d(c, 1, 7, padding=3) if with_post else None
    tensors, ints, out_shape = mrf_conv._stage_args(torch.zeros(2, c, t), blocks, KS, DILS, 0.1, post)
    assert ints[:6] == (2, c, 32, t, 3, 3)
    assert list(ints[6]) == list(KS) and list(ints[7]) == [1, 3, 5] * 3
    assert ints[8] == pytest.approx(0.1) and ints[9] == (7 if with_post else 0)
    assert ints[10] == (63 if with_post else 60)
    w, b = mrf_conv._pack(blocks, DILS, c, 32, "cpu")
    assert tensors[0] is w and tensors[1] is b
    if with_post:
        assert torch.equal(tensors[2], post.weight.detach().reshape(c, 7)) and torch.equal(tensors[3], post.bias.detach())
    assert out_shape == ((2, 1, t) if with_post else (2, c, t))
