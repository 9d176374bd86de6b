"""The host side of the port's bf16 wgmma kernels (csrc/flash_fwd_sm90.cu:
K1, K6, K3; csrc/flash_bwd_sm90.cu: K4, K5; csrc/attn_diag_sm90.cu,
attn_diag_grid3_sm90.cu and attn_diag_k8_k10_sm90.cu: the diagnostic K7,
K9, K8 and K10 on K1's loop): which library function each
call reaches, what it is handed, and the tools that break or vary the
kernels' sources by text (the fault check and the design-variant timers),
held to the sources as they are. The kernels themselves run only on the
card (``chip_smoke.py``; the ``gpu`` tests below at small shapes)."""

import ctypes
import math
import os
import re
from collections import Counter

import pytest
import torch

from audioldm_tpu_torch.kernels import _build, fault_check
from audioldm_tpu_torch.kernels import attn_diag as ad
from audioldm_tpu_torch.kernels import flash_attention as fa
from audioldm_tpu_torch.tools import (attn_diag_sm90_variants, flash_bwd_sm90_variants, flash_sm90_variants, mrf_variants,
                                      devtime, sass_guard)

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "audioldm_tpu_torch", "csrc")


def _source(name: str) -> str:
    with open(os.path.join(_CSRC, name)) as f:
        return f.read()


@pytest.mark.parametrize("fault", [name for name, f in fault_check.FAULTS.items() if f is not None])
def test_every_fault_breaks_one_line_of_its_source(fault):
    """Each fault of ``fault_check`` finds the text it replaces exactly once
    (each of its lines, where it breaks several), in a source whose kernels
    some chip_smoke cases hold (the fault's own cases where it names them)."""
    source, line, faulty, *own = fault_check.FAULTS[fault]
    text = _source(source)
    for old, new in fault_check.edits(line, faulty):
        assert text.count(old) == 1 and new != old
        text = text.replace(old, new)
    assert fault_check.CASES[source]
    assert all(hasattr(__import__("chip_smoke"), c) for c in (own[0] if own else fault_check.CASES[source]))


@pytest.mark.parametrize("variant", list(flash_sm90_variants.VARIANTS))
def test_every_design_variant_applies_to_the_kernel(variant):
    text = _source("flash_fwd_sm90.cuh")
    for old, new in flash_sm90_variants.VARIANTS[variant]:
        assert text.count(old) == 1
        text = text.replace(old, new)


@pytest.mark.parametrize("variant", list(attn_diag_sm90_variants.VARIANTS))
def test_every_k7_k9_variant_applies_to_the_kernel(variant):
    texts = {}
    for fname, old, new in attn_diag_sm90_variants.VARIANTS[variant]:
        text = texts.setdefault(fname, _source(fname))
        assert text.count(old) == 1
        texts[fname] = text.replace(old, new)


@pytest.mark.parametrize("variant", list(flash_bwd_sm90_variants.VARIANTS))
def test_every_k4_k5_variant_applies_to_the_kernel(variant):
    text = _source("flash_bwd_sm90.cu")
    for old, new in flash_bwd_sm90_variants.VARIANTS[variant]:
        assert text.count(old) == 1
        text = text.replace(old, new)


@pytest.mark.parametrize("variant", list(mrf_variants.VARIANTS))
def test_every_k2_variant_applies_to_the_kernel(variant):
    text = _source("mrf_conv.cu")
    for old, new in mrf_variants.VARIANTS[variant]:
        assert text.count(old) == 1
        text = text.replace(old, new)


def test_build_function_sets_the_signature_once(monkeypatch):
    """``_build.function`` looks a C function up and sets its restype and
    argtypes on the first call only; later calls return the same object."""
    libc = ctypes.CDLL(None)
    loads = []
    monkeypatch.setattr(_build, "load", lambda name: loads.append(name) or libc)
    monkeypatch.setattr(_build, "_fns", {})
    f = _build.function("libc", "labs", [ctypes.c_long])
    assert f.restype is ctypes.c_int and f.argtypes == [ctypes.c_long] and loads == ["libc"]
    assert _build.function("libc", "labs", [ctypes.c_long]) is f and loads == ["libc"]
    assert f(-7) == 7


def _mock_launches(monkeypatch):
    """``_build.function`` replaced by a recorder of ((library, function),
    args); the current stream by one whose handle is 1234; the launch
    counters by empty ones for the test's duration."""
    calls = []

    def function(lib, name, argtypes):
        def call(*args):
            calls.append(((lib, name), args))
            return 0
        return call

    class Stream:
        cuda_stream = 1234

    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    # the wrappers' launch counters, fresh for the test and restored after it
    for fn in (fa.flash_attention, fa.flash_fwd_lse, fa.flash_bwd_dkv, fa.flash_bwd_dq, ad.diag_loop, ad.fori_exp2, ad.grid3,
               ad.grid3b):
        monkeypatch.setattr(fn, "launches", Counter())
    monkeypatch.setattr(fa.flash_attention, "launches_one", Counter())
    return calls


@pytest.mark.parametrize("dtype,one,want", [
    (torch.bfloat16, False, ("flash_fwd_sm90", "flash_fwd_sm90")),
    (torch.bfloat16, True, ("flash_fwd_sm90", "flash_fwd_sm90")),
    (torch.float32, False, ("flash_attention", "flash_fwd")),
    (torch.float32, True, ("flash_attention_one", "flash_fwd_one")),
])
def test_inference_calls_reach_the_new_kernel_in_bf16(monkeypatch, dtype, one, want):
    """bf16 K1 and K6 go to ``flash_fwd_sm90`` (no bf16 call reaches the
    previous design's ``flash_fwd``), fp32 stays where it was. The C
    function gets the head views' pointers, (B, H, N, M, D), the twelve
    (b, h, n) strides of q, k, v and the [B, N, H, D] output, and
    log2(e)/sqrt(d)."""
    calls = _mock_launches(monkeypatch)
    b, n, h, d = 2, 40, 3, 24
    q, k, v = (torch.zeros(b, n, h * d, dtype=dtype).view(b, n, h, d).transpose(1, 2) for _ in range(3))
    out = fa._launch_fwd(q, k, v, 1.0 / math.sqrt(d), one)
    assert out.shape == (b, h, n, d) and out.stride() == (n * h * d, d, h * d, 1)
    ((lib_fn, args),) = calls
    assert lib_fn == want
    ptrs, dims, strides, c, stream = args[:4], args[4:9], args[9], args[10], args[-1]
    assert len(args) == (13 if dtype == torch.bfloat16 else 12)
    if dtype == torch.bfloat16:
        assert args[11] == int(one)
    assert ptrs == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    assert dims == (b, h, n, n, d) and stream == 1234
    assert list(strides) == [n * h * d, d, h * d] * 4
    assert c == pytest.approx(fa._LOG2E / math.sqrt(d))


@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, ("flash_fwd_sm90", "flash_fwd_sm90_lse")),
    (torch.float32, ("flash_attention", "flash_fwd_lse")),
])
def test_k3_reaches_the_lse_variant_of_the_new_kernel_in_bf16(monkeypatch, dtype, want):
    """bf16 K3 goes to ``flash_fwd_sm90_lse`` (the lse flag of the sm90
    kernel), fp32 K3 stays in ``flash_attention.cu``. Both get q2 as it is
    handed over, the five pointers (q2, k, v, the [B, N, H, D] output, the
    contiguous fp32 [B, H, N] lse2), (B, H, N, M, D), the twelve strides,
    and 1.0 for the scale: q2 is already pre-scaled and rounded."""
    calls = _mock_launches(monkeypatch)
    b, n, h, d = 2, 40, 3, 24
    q2, k, v = (torch.zeros(b, n, h * d, dtype=dtype).view(b, n, h, d).transpose(1, 2) for _ in range(3))
    out, lse = fa._launch_lse(q2, k, v)
    ((lib_fn, args),) = calls
    assert lib_fn == want and len(args) == 13
    assert args[:5] == (q2.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr())
    assert args[5:10] == (b, h, n, n, d) and list(args[10]) == [n * h * d, d, h * d] * 4
    assert args[11] == 1.0 and args[12] == 1234
    assert lse.shape == (b, h, n) and lse.dtype == torch.float32 and lse.is_contiguous()
    assert out.shape == (b, h, n, d) and out.stride() == (n * h * d, d, h * d, 1)


@pytest.mark.parametrize("name", ["flash_bwd_dkv", "flash_bwd_dq"])
def test_k4_and_k5_are_handed_q2_and_the_tpu_kernels_factors(monkeypatch, name):
    """K4 and K5 get the forward's q2 (no scale left to apply to the
    logits), ``scale = 1/sqrt(d)`` for dS, and K4 also ``1/(scale log2(e))``
    for its fp32 dS^T q2 (the TPU kernel's order of roundings)."""
    calls = _mock_launches(monkeypatch)
    b, n, h, d = 1, 24, 2, 16
    q2, k, v, dout = (torch.zeros(b, n, h * d, dtype=torch.bfloat16).view(b, n, h, d).transpose(1, 2) for _ in range(4))
    lse2 = delta = torch.zeros(b, h, n)
    outs = getattr(fa, name)(q2, k, v, dout, lse2, delta, 0.25)
    ((lib_fn, args),) = calls
    assert lib_fn == ("flash_bwd_sm90", name) and args[0] == 1 and args[1] == q2.data_ptr()
    factors = args[-3:-1] if name == "flash_bwd_dkv" else args[-2:-1]
    want = (0.25, 1.0 / (0.25 * fa._LOG2E)) if name == "flash_bwd_dkv" else (0.25,)
    assert factors == pytest.approx(want) and args[-1] == 1234
    assert len(args) == len(fa._BWD_ARGS[name]) and len(outs if isinstance(outs, tuple) else (outs,)) == (2 if name == "flash_bwd_dkv" else 1)


@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, "flash_bwd_sm90"),
    (torch.float32, "flash_attention_bwd"),
])
@pytest.mark.parametrize("name", ["flash_bwd_dkv", "flash_bwd_dq"])
def test_k4_and_k5_reach_the_new_kernels_in_bf16(monkeypatch, name, dtype, want):
    """bf16 K4 and K5 go to ``flash_bwd_sm90`` (no bf16 call reaches the
    previous design's ``flash_attention_bwd``), fp32 stays where it was.
    Both libraries get the same arguments: the dtype flag, q2 as handed
    over, k, v, dO, lse2, delta and the outputs, (B, H, N, M, D), the 18
    (b, h, n) strides (the outputs are [B, N, H, D] buffers), ``scale`` and
    for K4 ``1/(scale log2(e))``, and the stream."""
    calls = _mock_launches(monkeypatch)
    b, n, m, h, d = 2, 40, 24, 3, 24
    q2, dout = (torch.zeros(b, n, h * d, dtype=dtype).view(b, n, h, d).transpose(1, 2) for _ in range(2))
    k, v = (torch.zeros(b, m, h * d, dtype=dtype).view(b, m, h, d).transpose(1, 2) for _ in range(2))
    lse2, delta = torch.zeros(b, h, n), torch.ones(b, h, n)
    outs = getattr(fa, name)(q2, k, v, dout, lse2, delta)
    outs = outs if isinstance(outs, tuple) else (outs,)
    ((lib_fn, args),) = calls
    assert lib_fn == (want, name) and len(args) == len(fa._BWD_ARGS[name])
    assert args[0] == int(dtype == torch.bfloat16)
    ptrs = (q2, k, v, dout, lse2, delta, *outs)
    assert args[1:1 + len(ptrs)] == tuple(t.data_ptr() for t in ptrs)
    dims, strides = args[1 + len(ptrs):6 + len(ptrs)], args[6 + len(ptrs)]
    assert dims == (b, h, n, m, d) and args[-1] == 1234
    q_rows, kv_rows = [n * h * d, d, h * d], [m * h * d, d, h * d]
    out_rows = kv_rows if name == "flash_bwd_dkv" else q_rows
    assert list(strides) == q_rows + kv_rows * 2 + q_rows + out_rows * 2
    for o, like in zip(outs, (k, v) if name == "flash_bwd_dkv" else (q2,)):
        assert o.shape == like.shape and o.stride() == like.stride()
    scale = 1.0 / math.sqrt(d)
    want_factors = (scale, 1.0 / (scale * fa._LOG2E)) if name == "flash_bwd_dkv" else (scale,)
    assert args[7 + len(ptrs):-1] == pytest.approx(want_factors)


class _Props:
    multi_processor_count = 132


def _diag_inputs(b, h, n, d, dtype=torch.bfloat16):
    """q, k, v as [B, H, N, D] head views of [B, N, H * D] projections."""
    return [torch.zeros(b, n, h * d, dtype=dtype).view(b, n, h, d).transpose(1, 2) for _ in range(3)]


@pytest.mark.parametrize("name,block_k", [("full", 64), ("exp2", 64), ("exp2", 128), ("exp2", 256), ("no_max", 64),
                                          ("no_exp", 64), ("matmul_only", 64), ("grid3", 64)])
def test_k7_and_k9_reach_the_sm90_entry_in_bf16(monkeypatch, name, block_k):
    """bf16 K7 (each variant) goes to ``attn_diag_sm90`` and K9 to
    ``attn_diag_grid3_sm90``, both on K1's loop. The C function gets (K7)
    the kind, the head views' pointers (q, k, v as handed over; a contiguous
    [B, H, N, D] output), (B, H, N, D), the twelve (b, h, n) strides, the
    scale (K7 1/sqrt(d): q loads unscaled; K9 log2(e)/sqrt(d)), then K7's
    block_k or K9's q rows a CTA, and the stream; the wrapper counts one
    launch."""
    calls = _mock_launches(monkeypatch)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device=None: _Props())
    monkeypatch.setattr(ad, "_is_cuda", lambda t: True)
    b, h, n, d = 1, 2, 256, 24
    q, k, v = _diag_inputs(b, h, n, d)
    out = ad.grid3(q, k, v, 64, 64) if name == "grid3" else ad.diag_loop(q, k, v, name, block_k)
    ((lib_fn, args),) = calls
    if name == "grid3":
        assert lib_fn == ("attn_diag_grid3_sm90", "attn_diag_grid3_sm90") and len(args) == len(ad._GRID3_ARGS)
        assert args[-2] == ad.q_rows(b, h, n, d, 132) == 64
    else:
        assert lib_fn == ("attn_diag_sm90", "attn_diag_sm90") and len(args) == len(ad._SM90_ARGS)
        assert args[0] == ad._KIND[name] and args[-2] == block_k
        args = args[1:]
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()) and args[4:8] == (b, h, n, d)
    assert list(args[8]) == [n * h * d, d, h * d] * 3 + [h * n * d, n * d, d]
    scale = (ad.LOG2E if name == "grid3" else 1.0) / math.sqrt(d)
    assert args[9] == pytest.approx(scale) and args[-1] == 1234
    assert out.shape == (b, h, n, d) and out.is_contiguous()
    counter = ad.grid3.launches if name == "grid3" else ad.diag_loop.launches
    key = ("bfloat16", (b, h, n, d)) + (() if name == "grid3" else (name, block_k))
    assert counter == Counter({key: 1})


@pytest.mark.parametrize("name", ["fori_exp2", "grid3b"])
def test_k8_and_k10_reach_the_sm90_entry_in_bf16(monkeypatch, name):
    """bf16 K8 and K10 go to ``attn_diag_k8_k10_sm90``, on K1's loop. The C
    function gets their kind, the head views' pointers (q, k, v as handed
    over, no contiguous copy; a contiguous [B, H, N, D] output), (B, H, N,
    D), the twelve (b, h, n) strides, log2(e)/sqrt(d) and the stream; the
    wrapper counts one launch."""
    calls = _mock_launches(monkeypatch)
    monkeypatch.setattr(ad, "_is_cuda", lambda t: True)
    b, h, n, d = 1, 2, 256, 24
    q, k, v = _diag_inputs(b, h, n, d)
    out = getattr(ad, name)(q, k, v, 64, 128)
    ((lib_fn, args),) = calls
    assert lib_fn == ("attn_diag_k8_k10_sm90", "attn_diag_k8_k10_sm90") and len(args) == len(ad._K8_K10_ARGS)
    assert args[0] == ad._KIND[name] and args[1:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    assert args[5:9] == (b, h, n, d) and list(args[9]) == [n * h * d, d, h * d] * 3 + [h * n * d, n * d, d]
    assert args[10] == pytest.approx(ad.LOG2E / math.sqrt(d)) and args[-1] == 1234
    assert out.shape == (b, h, n, d) and out.is_contiguous()
    assert getattr(ad, name).launches == Counter({("bfloat16", (b, h, n, d)): 1})


_DIAG_CALLS = {**{v: lambda q, k, v_, name=v: ad.diag_loop(q, k, v_, name, 64) for v in ad.VARIANTS},
               **{n: lambda q, k, v_, name=n: getattr(ad, name)(q, k, v_, 64, 64) for n in ("fori_exp2", "grid3", "grid3b")}}
_DIAG_LIBS = {"attn_diag_sm90", "attn_diag_grid3_sm90", "attn_diag_k8_k10_sm90"}


@pytest.mark.parametrize("name", list(_DIAG_CALLS))
def test_every_diag_wrapper_reaches_only_the_sm90_libraries(monkeypatch, name):
    """No wrapper of ``kernels/attn_diag.py`` reaches a library other than
    the three built from the sm90 diag sources, each one C entry of the
    library's name; the previous loop's ``attn_diag`` is not built at all."""
    calls = _mock_launches(monkeypatch)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device=None: _Props())
    monkeypatch.setattr(ad, "_is_cuda", lambda t: True)
    _DIAG_CALLS[name](*_diag_inputs(2, 2, 128, 40))
    ((lib_fn, _),) = calls
    assert lib_fn[0] in _DIAG_LIBS and lib_fn == (ad._ENTRY[name], ad._ENTRY[name])
    assert _DIAG_LIBS <= set(_build.SOURCES) and "attn_diag" not in _build.SOURCES
    assert not os.path.exists(os.path.join(_CSRC, "attn_diag.cu"))


@pytest.mark.parametrize("name", ["fori_exp2", "grid3b"])
def test_fp32_k8_and_k10_raise_before_a_launch(monkeypatch, name):
    """What the fp32 kernel does not take raises on CUDA before anything is
    built or launched, as for K7 and K9: a head dim over the 128 its
    registers hold, and a block_k that is not whole 32-row tiles (K8 and
    K10 commit their max once a block)."""
    calls = _mock_launches(monkeypatch)
    monkeypatch.setattr(ad, "_is_cuda", lambda t: True)
    q, k, v = _diag_inputs(1, 2, 128, 136, torch.float32)
    with pytest.raises(ValueError, match="D <= 128"):
        getattr(ad, name)(q, k, v, 64, 64)
    q, k, v = _diag_inputs(1, 2, 192, 16, torch.float32)
    with pytest.raises(ValueError, match="whole 32-row tiles"):
        getattr(ad, name)(q, k, v, 64, 48)
    assert calls == []


@pytest.mark.parametrize("name", list(ad.VARIANTS) + ["grid3"])
def test_fp32_k7_and_k9_raise_before_a_launch(monkeypatch, name):
    """What the fp32 kernel does not take raises on CUDA before anything is
    built or launched: a head dim over 128, and, for the kinds that commit
    their max once a block (full, exp2, K9), a block_k that is not whole
    32-row tiles; the others take any block_k."""
    calls = _mock_launches(monkeypatch)
    monkeypatch.setattr(ad, "_is_cuda", lambda t: True)
    run = lambda q, k, v, bk: ad.grid3(q, k, v, 64, bk) if name == "grid3" else ad.diag_loop(q, k, v, name, bk)
    with pytest.raises(ValueError, match="D <= 128"):
        run(*_diag_inputs(1, 2, 128, 136, torch.float32), 64)
    assert calls == []
    if name in ad._COMMITS_MAX:
        with pytest.raises(ValueError, match="whole 32-row tiles"):
            run(*_diag_inputs(1, 2, 192, 16, torch.float32), 48)
        assert calls == []
    else:
        run(*_diag_inputs(1, 2, 192, 16, torch.float32), 48)
        assert [lib_fn for lib_fn, _ in calls] == [("attn_diag_f32", "attn_diag_f32")]


@pytest.mark.parametrize("name", list(_DIAG_CALLS))
def test_fp32_diag_reaches_the_f32_entry(monkeypatch, name):
    """fp32 K7 (each variant), K8, K9 and K10 go to ``attn_diag_f32``: the
    kind, the head views' pointers (no copy), (B, H, N, D), the twelve (b,
    h, n) strides, the scale (K7 1/sqrt(d), K8-K10 log2(e)/sqrt(d)), block_k
    and the stream; the wrapper counts one launch under its bf16 key's
    form."""
    calls = _mock_launches(monkeypatch)
    monkeypatch.setattr(ad, "_is_cuda", lambda t: True)
    b, h, n, d = 1, 2, 256, 24
    q, k, v = _diag_inputs(b, h, n, d, torch.float32)
    out = _DIAG_CALLS[name](q, k, v)
    ((lib_fn, args),) = calls
    assert lib_fn == ("attn_diag_f32", "attn_diag_f32") and len(args) == len(ad._F32_ARGS)
    assert args[0] == ad._KIND[name] and args[1:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    assert args[5:9] == (b, h, n, d) and list(args[9]) == [n * h * d, d, h * d] * 3 + [h * n * d, n * d, d]
    scale = (1.0 if name in ad.VARIANTS else ad.LOG2E) / math.sqrt(d)
    assert args[10] == pytest.approx(scale) and args[11] == 64 and args[-1] == 1234
    assert out.shape == (b, h, n, d) and out.dtype == torch.float32 and out.is_contiguous()
    counter = ad.diag_loop.launches if name in ad.VARIANTS else getattr(ad, name).launches
    key = ("float32", (b, h, n, d)) + ((name, 64) if name in ad.VARIANTS else ())
    assert counter == Counter({key: 1})


@pytest.mark.parametrize("shape,rows", [((2, 8, 512, 64), 64), ((2, 8, 1024, 32), 64), ((2, 8, 2048, 16), 64),
                                        ((2, 8, 4096, 16), 128), ((2, 8, 4032, 16), 128), ((1, 8, 512, 128), 64),
                                        ((2, 8, 2048, 128), 128)])
def test_k9_takes_64_row_tiles_when_the_128_row_grid_is_under_one_wave(shape, rows):
    """On 132 SMs: 128-row tiles fill 2 CTAs an SM at d <= 32 and 1 above;
    under that many CTAs, K9 runs 64 rows a CTA in one warpgroup."""
    assert ad.q_rows(*shape, 132) == rows


def test_sass_guard_keys_instances_by_template_arguments():
    """The guard compares K1/K6/K3 and K7/K9 instances across builds by their
    template arguments: the mangled names differ by the anonymous
    namespace's hash; the diag kernel's carry the value of ``Fwd``."""
    counts = {"_ZN73_INTERNAL_abc_17_flash_fwd_sm90_cu_x121flash_fwd_sm90_kernelILi32ELb1ELb0EEEvT": {"REG": 90},
              "_ZN8fwd_sm9021attn_diag_sm90_kernelILi16ELNS_3FwdE4ELi2EEEvv": {"REG": 80},
              "_ZN8fwd_sm9021attn_diag_sm90_kernelILi128ELNS_3FwdE11ELi2EEEvv": {"REG": 70},
              "_ZN8fwd_sm9015mrf_stage_kernelILi32EEEvv": {"REG": 60}}
    assert sass_guard.instances(counts) == {"flash_fwd_sm90_kernel<32, true, false>": {"REG": 90},
                                            "attn_diag_sm90_kernel<16, Fwd::FULL, 2>": {"REG": 80},
                                            "attn_diag_sm90_kernel<128, Fwd::K10, 2>": {"REG": 70}}


def test_devtime_probe_needs_a_gpu(capsys):
    """The probe of the profiler's records exits nonzero without a GPU,
    before it runs any phase."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert devtime.main([]) == 1 and "no CUDA GPU" in capsys.readouterr().err


def test_sass_guard_names_every_fwd_variant_in_order():
    """``sass_guard.FWD`` lists ``enum class Fwd`` of the shared loop in its
    order, so a mangled value names the right variant."""
    enum = re.search(r"enum class Fwd \{([^}]*)\}", _source("flash_fwd_sm90.cuh")).group(1)
    assert tuple(x.strip() for x in enum.split(",")) == sass_guard.FWD


@pytest.mark.gpu
def test_k4_and_k5_match_their_plain_versions_on_the_gpu():
    """K4 and K5 (bf16, ``csrc/flash_bwd_sm90.cu``) against
    ``flash_bwd_plain`` at small shapes, one ragged with a head dim padded
    to 64 (the full-size checks are ``chip_smoke.py kernels``): each of dq,
    dk, dv within max|ref| / 64, and a second launch gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU form")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, n, d in ((1, 2, 256, 16), (1, 2, 200, 40)):
        q, k, v, dout = (torch.randn(b, n, h * d, device="cuda", generator=gen).bfloat16().view(b, n, h, d).transpose(1, 2)
                         for _ in range(4))
        q2 = fa.prescale(q)
        o, lse = fa.flash_fwd_lse_plain(q2, k, v)
        delta = (dout.float() * o.float()).sum(dim=-1).contiguous()
        dk, dv = fa.flash_bwd_dkv(q2, k, v, dout, lse, delta)
        dq = fa.flash_bwd_dq(q2, k, v, dout, lse, delta)
        for got, ref in zip((dq, dk, dv), fa.flash_bwd_plain(q2, k, v, o, lse, dout)):
            assert (got.double() - ref.double()).abs().max().item() <= ref.double().abs().max().item() / 64
        dk2, dv2 = fa.flash_bwd_dkv(q2, k, v, dout, lse, delta)
        assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
        assert torch.equal(dq, fa.flash_bwd_dq(q2, k, v, dout, lse, delta))


@pytest.mark.gpu
def test_k1_and_k6_match_their_plain_versions_on_the_gpu():
    """K1 and K6 against ``flash_plain`` and ``flash_one_plain`` at small
    shapes, one ragged with a padded head dim (the full-size checks are
    ``chip_smoke.py kernels``): max |d| within max|ref| / 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU form")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, n, d in ((1, 2, 256, 16), (1, 2, 200, 40)):
        q, k, v = (torch.randn(b, n, h * d, device="cuda", generator=gen).bfloat16().view(b, n, h, d).transpose(1, 2)
                   for _ in range(3))
        for one, plain in ((False, fa.flash_plain), (True, fa.flash_one_plain)):
            fa.set_one_pass(one)
            try:
                got = fa.flash_attention(q, k, v).double()
            finally:
                fa.set_one_pass(False)
            ref = plain(q, k, v).double()
            assert (got - ref).abs().max().item() <= ref.abs().max().item() / 64


@pytest.mark.gpu
def test_k3_and_k2_match_their_plain_versions_on_the_gpu():
    """K3 (the lse variant of the sm90 kernel) against ``flash_fwd_lse_plain``
    (out within max|ref| / 64, lse2 within 1e-4) and K2 against
    ``mrf_stage_plain`` (TF32 off; 1e-4 max|ref|) at small shapes, one of
    each ragged (the full-size checks are ``chip_smoke.py kernels``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU form")
    from audioldm_tpu_torch.kernels import mrf_conv
    from audioldm_tpu_torch.models.vocoder import HifiGanResidualBlock

    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, n, d in ((1, 2, 256, 16), (1, 2, 200, 32)):
        q, k, v = (torch.randn(b, n, h * d, device="cuda", generator=gen).bfloat16().view(b, n, h, d).transpose(1, 2)
                   for _ in range(3))
        q2 = fa.prescale(q)
        out, lse = fa.flash_fwd_lse(q2, k, v)
        ref, ref_lse = fa.flash_fwd_lse_plain(q2, k, v)
        assert (out.double() - ref.double()).abs().max().item() <= ref.double().abs().max().item() / 64
        assert (lse - ref_lse).abs().max().item() <= 1e-4
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for c, t, with_post in ((64, 1000, False), (32, 700, True)):
            with torch.device("cuda"):
                blocks = [HifiGanResidualBlock(c, kk, dd) for kk, dd in zip((3, 7, 11), ((1, 3, 5),) * 3)]
                post = torch.nn.Conv1d(c, 1, 7, padding=3) if with_post else None
            x = torch.randn(1, c, t, device="cuda", generator=gen)
            with torch.no_grad():
                got = mrf_conv.mrf_stage(x, blocks, (3, 7, 11), ((1, 3, 5),) * 3, 0.1, post)
                ref = mrf_conv.mrf_stage_plain(x, blocks, (3, 7, 11), ((1, 3, 5),) * 3, 0.1, post)
            assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
