"""The port's kernel modules (audioldm_tpu_torch/kernels) against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

On a CPU tensor each wrapper computes its plain PyTorch version, which is
what these tests hold against the Pallas kernel; the CUDA kernels themselves
are held against the same plain versions on the card by chip_smoke.py.
Inputs are made with numpy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioldm_tpu.kernels import mrf_conv as jax_mrf
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
    """fp32: 1e-5; bf16: 2e-2 (P is rounded to bf16 before the PV product,
    in a different place in each kernel)."""
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


def test_flash_wrapper_refuses_other_devices():
    q = torch.empty((1, 1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("n,m,d", [(4096, 4096, 16), (4000, 4000, 16), (2048, 2048, 128), (1024, 1024, 32), (4096, 4096, 160)])
def test_flash_routing_rule_matches_jax(n, m, d):
    assert fa.supported(n, m, d) == jax_flash_supported(n, m, d)


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


def test_mrf_weight_packing_layout_and_cache():
    """The kernel's weight layout: per conv a [ci, tap, co] block with the
    channels zero-padded to a multiple of 8, repacked only after a change."""
    c, cp = 12, 16
    blocks, _ = _resblocks(c, 3)
    w, b = mrf_conv._pack(blocks, DILS, c, cp, "cpu")
    assert w.numel() == sum(2 * len(d) * cp * k * cp for k, d in zip(KS, DILS)) and b.numel() == 18 * cp
    second = blocks[1].convs2[2]  # resblock 1 (k=7), unit 2, conv 2
    off = 2 * 3 * cp * 3 * cp + (2 * 2 + 1) * cp * 7 * cp
    block = w[off : off + cp * 7 * cp].reshape(cp, 7, cp)
    torch.testing.assert_close(block[:c, :, :c], second.weight.detach().permute(1, 2, 0), rtol=0, atol=0)
    assert not block[c:].any() and not block[:, :, c:].any()
    torch.testing.assert_close(b[(3 * 2 + 2 * 2 + 1) * cp :][:c], second.bias.detach(), rtol=0, atol=0)
    again = mrf_conv._pack(blocks, DILS, c, cp, "cpu")
    assert again[0] is w and again[1] is b
    with torch.no_grad():
        second.weight.mul_(2.0)
    w2, _ = mrf_conv._pack(blocks, DILS, c, cp, "cpu")
    assert w2 is not w
    torch.testing.assert_close(w2[off : off + cp * 7 * cp], 2 * w[off : off + cp * 7 * cp], rtol=0, atol=0)
