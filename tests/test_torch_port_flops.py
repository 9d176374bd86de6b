"""The port's FLOP counter (audioldm_tpu_torch/utils/flops.py) against the
JAX package's useful counts, and its serving bench
(audioldm_tpu_torch/tools/bench_serving.py) driven on the CPU at the tiny
widths of tests/test_torch_port_pipeline.py.

The counts are exact integers in float64 on both sides, so they are held
equal; the JAX package's counter is itself held to XLA's cost analysis in
tests/test_flops.py.
"""

import re

import pytest
import torch

from audioldm_tpu import config as jcfg
from audioldm_tpu.utils import flops as jfl
from audioldm_tpu_torch import config as tcfg
from audioldm_tpu_torch.pipeline import generate as pg
from audioldm_tpu_torch.tools import bench_serving as bench
from audioldm_tpu_torch.utils import flops as fl
from test_torch_port_pipeline import SECONDS, TEXT, UNET, VAE, VOC

# audioldm-s at full width, and the tiny geometry of the CPU tests
GEOMETRIES = {
    "full": ({}, {}, {}, {}),
    "tiny": (UNET, VAE, VOC, TEXT),
}


def _cfgs(name, lib):
    u, v, voc, t = GEOMETRIES[name]
    return lib.UNetConfig(**u), lib.VAEConfig(**v), lib.VocoderConfig(**voc), lib.ClapTextConfig(**t)


def _same(ours: fl.FlopCount, theirs) -> None:
    assert ours.useful == theirs.useful > 0
    assert ours.by_category == {k: u for k, (u, _) in theirs.by_category.items()}


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_module_counts_equal_jax(geometry):
    (u, v, voc, t), (ju, jv, jvoc, jt) = _cfgs(geometry, tcfg), _cfgs(geometry, jcfg)
    _same(fl.unet_step_flops(u, 2, 256, 16), jfl.unet_step_flops(ju, 2, 256, 16))
    _same(fl.vae_encode_flops(v, 1, 1024, 64), jfl.vae_encode_flops(jv, 1, 1024, 64))
    _same(fl.vae_decode_flops(v, 3, 256, 16), jfl.vae_decode_flops(jv, 3, 256, 16))
    _same(fl.vocoder_flops(voc, 2, 1024), jfl.vocoder_flops(jvoc, 2, 1024))
    _same(fl.clap_text_flops(t, 2, 512), jfl.clap_text_flops(jt, 2, 512))


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_workload_counts_equal_jax(geometry):
    (u, v, voc, t), (ju, jv, jvoc, jt) = _cfgs(geometry, tcfg), _cfgs(geometry, jcfg)
    for kw in (dict(steps=50), dict(steps=25, batch=4, latent_h=128, seqlen=64)):
        ours, theirs = fl.pipeline_flops(u, v, voc, t, **kw), jfl.pipeline_flops(ju, jv, jvoc, jt, **kw)
        assert ours.keys() == theirs.keys()
        for k in ours:
            _same(ours[k], theirs[k])
    for remat in (False, True):
        ours, theirs = fl.train_step_flops(u, v, t, batch=2, remat=remat), jfl.train_step_flops(ju, jv, jt, batch=2, remat=remat)
        assert ours.keys() == theirs.keys()
        for k in ours:
            _same(ours[k], theirs[k])


def test_mfu_is_against_the_h100_bf16_peak():
    assert fl.H100_SXM_BF16_PEAK == 989e12 and not hasattr(fl, "V5E_BF16_PEAK")
    assert fl.mfu(989e12, 2.0) == pytest.approx(0.5, rel=1e-12)
    assert not hasattr(fl.FlopCount(), "padded")
    txt = fl.summarize(fl.pipeline_flops(steps=50), seconds=1.0)
    assert "MFU" in txt and "unet_denoise" in txt


@pytest.fixture(scope="module")
def tiny():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield pg.random_modules(0, tcfg.UNetConfig(**UNET), tcfg.VAEConfig(**VAE), tcfg.ClapTextConfig(**TEXT),
                            tcfg.VocoderConfig(**VOC), device="cpu")
    torch.set_num_threads(n)


NUM = r"(\d+\.\d+)"
LINES = {  # each section's lines, in the JAX tool's words
    "sampler": rf"^(dpm\+\+|lcm) \d+ steps: {NUM} s/clip$",
    "serve": rf"^serve (batch=4 .+|merged batch=\d+): {NUM} s/batch = {NUM} s/clip \({NUM} clips/s\)$",
    "knee": rf"^(serve batch=\d+: {NUM} s/batch = {NUM} s/clip \({NUM} clips/s, mfu {NUM}\)|KNEE: batch=\d+ -> {NUM} "
            rf"clips/s/chip \({NUM} s/clip, mfu {NUM}\))$",
    "hybrid": rf"^serve mixed (rank-r|hybrid<=\d+): {NUM} s/batch = {NUM} s/clip$",
    "flush": rf"^flush n=8 chunks=4 (sequential|overlapped-flush): {NUM} s = {NUM} s/clip \({NUM} clips/s\)$",
}


def test_bench_sections_print_lines_that_parse(tiny, capsys):
    """Every section at the tiny geometry, one warm-up and one timed run:
    each prints one parseable line a measurement, and returns the same
    numbers."""
    kw = dict(device="cpu", seconds=SECONDS, warm=1, timed=1)
    got = {
        "sampler": [bench.sampler_latency(tiny, steps=(3, 2), **kw),
                    bench.sampler_latency(tiny, steps=(2, 1), scheduler="lcm", guidance=1.0, **kw)],
        "serve": [bench.serve_routes(tiny, steps=2, **kw), bench.batch_sweep(tiny, steps=2, batches=(1, 2), **kw)],
        "knee": [bench.throughput_knee(tiny, steps=2, batches=(1, 2), **kw)],
        "hybrid": [bench.hybrid_sweep(tiny, steps=2, dims=(None, 8), **kw)],
        "flush": [bench.flush_overlap(tiny, steps=2, **kw)],
    }
    lines = capsys.readouterr().out.strip().splitlines()
    counts = {name: sum(bool(re.match(p, line)) for line in lines) for name, p in LINES.items()}
    assert counts == {"sampler": 4, "serve": 5, "knee": 3, "hybrid": 2, "flush": 2}, lines
    assert len(lines) == sum(counts.values())
    assert "KNEE: batch=" in lines[-5]
    values = [v for runs in got.values() for r in runs for v in r.values()]
    assert all((v["s_per_batch"] if isinstance(v, dict) else v) > 0 for v in values)
    assert got["knee"][0][2]["mfu"] == pytest.approx(2 * bench.clip_flops(tiny, 2, SECONDS) / got["knee"][0][2]["s_per_batch"]
                                                     / fl.H100_SXM_BF16_PEAK)
