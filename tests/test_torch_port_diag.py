"""The port's attention diagnostic tool (audioldm_tpu_torch/tools and
kernels/attn_diag.py) against the JAX tool, tools/bench_attn_diag.py.

The JAX tool's Pallas kernels K7-K10 run on the CPU under
``pltpu.force_tpu_interpret_mode()`` (its ``pallas_call`` has no
``interpret`` argument). The port's wrappers compute their plain versions
on CPU tensors; the CUDA kernels are held against the same plain versions on
the card by ``chip_smoke.py diag``. Inputs are made with numpy from a seed
and handed to both.

Tolerances: fp32 1e-5; bf16 2 ulps of the reference's largest value (the
two sum in another order, so a P or an output may round the other way).
no_exp and matmul_only are compared row by row relative to the reference
row's largest value (they reach 1e22), no_exp without the rows whose float64
sum of scaled logits lies within 1 of 0, where the sign of the fp32 sum
picks between acc / l and acc * 1e20.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from audioldm_tpu_torch import kernels
from audioldm_tpu_torch.kernels import attn_diag as ad
from audioldm_tpu_torch.tools import bench_attn as tb
from audioldm_tpu_torch.tools import bench_attn_diag as td
from tools import bench_attn_diag as jax_diag
from tools.bench_attn import xla_sdpa

SHAPE = (1, 2, 256, 16)
SHAPE_D32 = (1, 2, 128, 32)
SHAPE_D64 = (1, 2, 128, 64)
SHAPE_D72 = (1, 2, 128, 72)  # padded to 128 on both sides: K10's ones lane at index 72


def _qkv(shape, seed=0):
    r = np.random.default_rng(seed)
    return [r.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _jax(fn, arrays, dtype, *args):
    with pltpu.force_tpu_interpret_mode():
        out = fn(*(jnp.asarray(a, getattr(jnp, dtype)) for a in arrays), *args)
    return np.asarray(out.astype(jnp.float32), np.float64)


def _port(fn, arrays, dtype, *args, **kw):
    before = kernels.launch_counts()
    out = fn(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays), *args, **kw)
    assert kernels.launch_counts() == before  # CPU tensors never launch
    return out.double().numpy()


def _tolerance(ref: np.ndarray, dtype: str) -> float:
    """fp32 1e-5 (relative above 1); bf16 2 ulps of max|ref| (8 significand bits)."""
    top = float(np.abs(ref).max())
    if dtype == "float32":
        return 1e-5 * max(1.0, top)
    return 2 * 2.0 ** (math.floor(math.log2(top)) - 7)


def _assert_close(got, ref, dtype, variant="full", arrays=None):
    if variant in ("no_exp", "matmul_only"):  # row by row, relative to the reference row
        scale = np.abs(ref).max(axis=-1, keepdims=True)
        got, ref = got / scale, ref / scale
        if variant == "no_exp":
            q, k, _ = (np.asarray(torch.from_numpy(a).to(getattr(torch, dtype)).double()) for a in arrays)
            lsum = (q @ np.swapaxes(k, -1, -2)).sum(axis=-1) / math.sqrt(q.shape[-1])
            keep = np.abs(lsum) > 1.0
            assert keep.mean() > 0.8
            got, ref = got[keep], ref[keep]
    err = float(np.abs(got - ref).max())
    assert err <= _tolerance(ref, dtype), (err, _tolerance(ref, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_k", [64, 256])
@pytest.mark.parametrize("variant", ad.VARIANTS)
def test_diag_loop_plain_matches_pallas(variant, block_k, dtype):
    """K7: every variant at a 64-row block and at one block of the whole kv
    axis, through the port tool's ``run``."""
    arrays = _qkv(SHAPE)
    ref = _jax(jax_diag.run, arrays, dtype, variant, 64, block_k)
    got = _port(td.run, arrays, dtype, variant, 64, block_k)
    _assert_close(got, ref, dtype, variant, arrays)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ad.VARIANTS)
def test_diag_loop_plain_matches_pallas_d32(variant, dtype):
    arrays = _qkv(SHAPE_D32, 1)
    ref = _jax(jax_diag.run, arrays, dtype, variant, 32, 64)
    got = _port(ad.diag_loop, arrays, dtype, variant, 64, block_q=32)
    _assert_close(got, ref, dtype, variant, arrays)


FLASH = {"fori_exp2": (jax_diag.run_fori_exp2, td.run_fori_exp2), "grid3": (jax_diag.run_grid3, td.run_grid3),
         "grid3b": (jax_diag.run_grid3b, td.run_grid3b)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,blocks", [(SHAPE, (64, 64)), (SHAPE_D32, (64, 128)), (SHAPE_D64, (64, 64)),
                                          (SHAPE_D72, (64, 64))])
@pytest.mark.parametrize("kernel", list(FLASH))
def test_flash_exp2_plain_matches_pallas(kernel, shape, blocks, dtype):
    """K8, K9 and K10: q pre-scaled and rounded to its dtype, base 2 from
    m = -1e30; K10's l from the ones lane of V."""
    arrays = _qkv(shape, 2)
    jax_fn, port_fn = FLASH[kernel]
    ref = _jax(jax_fn, arrays, dtype, *blocks)
    got = _port(port_fn, arrays, dtype, *blocks)
    _assert_close(got, ref, dtype)


def test_exp2_depends_on_block_k_as_in_jax():
    """exp2 commits the max once a block and never rescales: the result is
    softmax only at block_k = N, in both packages alike."""
    arrays = _qkv(SHAPE)
    sdpa = tb.sdpa_reference(*(torch.from_numpy(a) for a in arrays)).double().numpy()
    port = {bk: _port(ad.diag_loop, arrays, "float32", "exp2", bk) for bk in (64, 256)}
    jax = {bk: _jax(jax_diag.run, arrays, "float32", "exp2", 64, bk) for bk in (64, 256)}
    assert np.abs(port[64] - port[256]).max() > 0.1
    assert np.abs(jax[64] - jax[256]).max() > 0.1
    np.testing.assert_allclose(port[256], sdpa, atol=1e-5, rtol=0)
    np.testing.assert_allclose(port[64], jax[64], atol=1e-5, rtol=0)


def test_grid3b_sums_the_rounded_weights():
    """K10's l is the sum of P after rounding to v's dtype, K9's before: the
    two differ in bf16 and agree in fp32."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(SHAPE, 3))
    for dtype, differ in ((torch.bfloat16, True), (torch.float32, False)):
        a, b = (ad.flash_exp2_plain(q.to(dtype), k.to(dtype), v.to(dtype), 64, ones=o).float() for o in (False, True))
        assert bool((a != b).any()) == differ
        torch.testing.assert_close(a, b, atol=2e-2, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_reference_matches_xla_sdpa(dtype):
    arrays = _qkv(SHAPE, 4)
    ref = _jax(xla_sdpa, arrays, dtype)
    got = _port(tb.sdpa_reference, arrays, dtype)
    _assert_close(got, ref, dtype)


def _t(shape, dtype=torch.float32, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


@pytest.mark.parametrize("call,match", [
    (lambda: ad.diag_loop(_t((1, 1, 96, 16)), _t((1, 1, 96, 16)), _t((1, 1, 96, 16)), "full", 64), "not a multiple"),
    (lambda: ad.diag_loop(_t((1, 1, 128, 16)), _t((1, 1, 128, 16)), _t((1, 1, 128, 16)), "full", 64, block_q=48), "not a multiple"),
    (lambda: ad.fori_exp2(_t((1, 1, 96, 16)), _t((1, 1, 96, 16)), _t((1, 1, 96, 16)), 32, 64), "not a multiple"),
    (lambda: ad.grid3(_t((1, 1, 96, 16)), _t((1, 1, 96, 16)), _t((1, 1, 96, 16)), 64, 32), "not a multiple"),
    (lambda: ad.grid3b(_t((1, 1, 128, 128)), _t((1, 1, 128, 128)), _t((1, 1, 128, 128)), 64, 64), "D % 128"),
    (lambda: ad.diag_loop(_t((1, 1, 64, 16)), _t((1, 1, 64, 16)), _t((1, 1, 64, 16)), "no_scale", 64), "variant"),
    (lambda: ad.grid3(_t((1, 1, 64, 16)), _t((1, 1, 128, 16)), _t((1, 1, 64, 16)), 64, 64), "one shape"),
    (lambda: ad.grid3(*(_t((1, 1, 64, 16), torch.float16),) * 3, 64, 64), "dtype"),
    (lambda: ad.fori_exp2(*(_t((1, 1, 64, 16), device="meta"),) * 3, 64, 64), "unsupported device"),
])
def test_diag_wrappers_refuse(call, match):
    """Ragged N (the TPU grid would drop the tail rows in silence), K10 at
    D = 128 (no lane left for the ones column), and malformed calls."""
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("call,match", [
    (lambda: ad.diag_loop(*(_t((1, 1, 192, 24)),) * 3, "exp2", 48), "whole 32-row tiles"),
    (lambda: ad.diag_loop(*(_t((1, 1, 192, 16)),) * 3, "exp2", 32), "whole 64-row tiles"),
    (lambda: ad.diag_loop(*(_t((1, 1, 128, 136)),) * 3, "full", 64), "D <= 128"),
    (lambda: ad.fori_exp2(*(_t((1, 1, 96, 16), torch.bfloat16),) * 3, 32, 32), "N % 64"),
    (lambda: ad.grid3b(*(_t((1, 1, 128, 20), torch.bfloat16),) * 3, 64, 64), "D % 8"),
    (lambda: ad.diag_loop(*(_t((1, 1, 128, 16), torch.bfloat16),) * 3, "exp2", 32), "multiple of 64"),
])
def test_diag_cuda_path_refuses_before_launch(call, match, monkeypatch):
    """What the CUDA kernels do not take raises before anything is built or
    launched: the device check is mocked to say CUDA (the fp32 kernel's
    exp2 commits a max per block_k rows in whole tiles of its loop, 64 kv
    rows at D <= 16 and 32 above, and it takes D <= 128; the bf16 kernels
    run whole 64-row tiles, and exp2's max granularity must be whole
    tiles)."""
    monkeypatch.setattr(ad, "_is_cuda", lambda t: True)
    monkeypatch.setattr(ad._build, "load", lambda name: pytest.fail("nothing may be built"))
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.gpu
def test_diag_kernels_match_plain_on_the_gpu():
    """The CUDA kernels against their plain versions at a small shape (the
    full-size check is ``chip_smoke.py diag``): bf16 within max|ref| / 64;
    fp32 (``csrc/attn_diag_f32.cu``, the fp32 K1's loop) within 1e-5 * max(1, max|ref|), no_exp
    and matmul_only row by row relative to the reference row's max times
    the row's ``row_condition``, no_exp without the rows whose float64 sum of
    scaled logits lies within 1 of 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU form")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(1, 2, 256, 32, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
    pairs = [(lambda var=var, bk=bk: ad.diag_loop(q, k, v, var, bk), lambda var=var, bk=bk: ad.diag_loop_plain(q, k, v, var, bk))
             for var in ("full", "exp2", "no_max") for bk in (64, 256)]
    pairs += [(lambda fn=fn: fn(q, k, v, 64, 64), lambda fn=fn: ad.flash_exp2_plain(q, k, v, 64, ones=fn is ad.grid3b))
              for fn in (ad.fori_exp2, ad.grid3, ad.grid3b)]
    for run, plain in pairs:
        got, ref = run().double(), plain().double()
        assert (got - ref).abs().max().item() <= ref.abs().max().item() / 64
    q, k, v = (torch.randn(1, 2, 256, 32, device="cuda", generator=gen) for _ in range(3))
    lsum = torch.matmul(q.double(), k.double().transpose(-1, -2)).sum(dim=-1) / math.sqrt(32)
    before = kernels.launch_counts()
    for var in ad.VARIANTS:
        for bk in (64, 256):
            got, ref = ad.diag_loop(q, k, v, var, bk).double(), ad.diag_loop_plain(q, k, v, var, bk).double()
            if var in ("no_exp", "matmul_only"):
                scale = ref.abs().amax(dim=-1, keepdim=True) * ad.row_condition(q, k, v, var)
                got, ref = got / scale, ref / scale
                if var == "no_exp":
                    got, ref = got[lsum.abs() > 1.0], ref[lsum.abs() > 1.0]
            assert (got - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item()), (var, bk)
    for fn in (ad.fori_exp2, ad.grid3, ad.grid3b):
        for bk in (64, 128):
            got, ref = fn(q, k, v, 64, bk).double(), ad.flash_exp2_plain(q, k, v, bk, ones=fn is ad.grid3b).double()
            assert (got - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item()), (fn.__name__, bk)
    after = kernels.launch_counts()
    assert after["diag_loop"][("float32", (1, 2, 256, 32), "exp2", 256)] == before["diag_loop"].get(
        ("float32", (1, 2, 256, 32), "exp2", 256), 0) + 1


@pytest.mark.parametrize("section", list(td.SECTIONS))
def test_tool_sections_run_on_the_cpu(section, capsys):
    """Every section of the port's tool runs its arithmetic on CPU tensors
    at a small shape, times nothing, and ends with its JSON line."""
    fn = td.SECTIONS[section]
    small = {"shapes": ((1, 2, 128, 32), (1, 2, 256, 16))} if section == "v5" else {"shape": SHAPE}
    out = fn(iters=1, device="cpu", **small)
    assert out["card"] == "cpu" and out["results"]
    assert all(r["ms"] is None for r in out["results"])
    assert all(r["loop"] == (None if "reference" in r["name"] else "sm90") for r in out["results"])
    for r in out["results"]:
        if not r["name"].startswith(("no_exp", "matmul_only", "exp2 bq=64 bk=64")):
            assert r["max_abs_err_vs_reference"] <= r["reference_max_abs"] / 64, r
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"section": "' + section)


def test_bench_attn_runs_on_the_cpu():
    out = tb.bench(shapes=((1, 2, 256, 16),), iters=1, device="cpu")
    assert [r["name"] for r in out["results"]] == ["sdpa_reference", "flash_attention", "torch_sdpa"]
    assert all(r["ms"] is None and r["max_abs_err_vs_reference"] <= 2e-2 for r in out["results"])


def test_timed_needs_cuda_tensors_to_time():
    calls = []
    assert tb.timed(lambda x: calls.append(x), torch.zeros(1), iters=3, warmup=1) is None
    assert len(calls) == 4


def test_tools_need_a_gpu(capsys):
    """The command lines exit nonzero without a GPU; the section functions
    raise unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert td.cli(["v2"]) == 1
    assert tb.main([]) == 1
    assert "no CUDA GPU" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        td.main3(iters=1)
    with pytest.raises(SystemExit):
        td.cli(["v9"])


def test_run_grid3b_accepts_vmem_mb():
    arrays = [torch.from_numpy(a) for a in _qkv(SHAPE, 5)]
    torch.testing.assert_close(td.run_grid3b(*arrays, 64, 128, vmem_mb=64), td.run_grid3b(*arrays, 64, 128), atol=0, rtol=0)
