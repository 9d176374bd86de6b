"""The port's copies of the system's tools (audioldm_tpu_torch/tools/) driven
on the CPU at the tiny widths of ``benchkit.TINY`` with ``device="cpu"``:
each runs, prints its JSON line, and its keys are the expected ones; times
taken on the CPU mean nothing of a device and are not checked.

Where a tool computes a number that the JAX tool (tools/ at the repo root)
computes too, the two are held together on the same tiny weights: the UNet
step of ``bench_unet_step`` with attention ablated and with it routed, against
``apply_unet`` with the JAX tool's ablation (``nn.sdpa`` replaced by ``lambda
q, k, v, *a, **kw: v``), at 1e-4 (the test_torch_oracle convention for tiny
geometry); the interval's CFG steps and a2a's steps run, exactly. torch runs
one intra-op thread, as the other port tests do.
"""

import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioldm_tpu.config import DDIMConfig as JaxDDIMConfig
from audioldm_tpu.config import UNetConfig as JaxUNetConfig
from audioldm_tpu.models import nn as jax_nn
from audioldm_tpu.models.scheduler import inference_timesteps as jax_timesteps
from audioldm_tpu.models.unet import apply_unet, init_unet
from audioldm_tpu_torch import config as tcfg
from audioldm_tpu_torch.ckpt import from_jax_params
from audioldm_tpu_torch.kernels import flash_attention as fa
from audioldm_tpu_torch.models import nn as port_nn
from audioldm_tpu_torch.models.unet import UNet2DConditionModel
from audioldm_tpu_torch.pipeline.generate import random_modules
from audioldm_tpu_torch.tools import (bench_a2a, bench_compile, bench_conv1d_smallc, bench_guidance_interval,
                                      bench_longform, bench_matmul, bench_pipeline_tail, bench_train_step,
                                      bench_unet_step, bench_vocoder_mrf, check_perf, profile_pipeline,
                                      quality_proximity, read_trace)
from audioldm_tpu_torch.tools.benchkit import TINY
from test_torch_port_models import UNET, numpy_params

SECONDS, TOKENS, MEL = 0.08, 16, (16, 8)  # the tiny clip, caption length and log-mel
F32 = torch.float32


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def mods():
    return random_modules(seed=0, device="cpu", **TINY)


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_unet_step_runs_every_ablation(mods, capsys):
    out = bench_unet_step.ablation(mods, "cpu", iters=1, warm=1, seconds=SECONDS, dtype=F32)
    assert _last_json(capsys) == json.loads(json.dumps(out))
    assert out["card"] == "cpu" and out["tool"] == "bench_unet_step"
    assert list(out["runs"]) == ["flash_l0", "flash_l0_l1", "flash_l0_l1_l2", "flash_off", "sdpa_ablated"]
    assert all(r["k1_launches_per_step"] == 0 for r in out["runs"].values())  # CPU tensors never launch
    assert math.isfinite(out["attention_core_ms"]) and out["level0_tokens"] == out["shape"][2] * out["shape"][3]
    assert fa._MIN_TOKENS == 2048 and port_nn.sdpa.__name__ == "sdpa"  # both restored


@pytest.mark.parametrize("run,ablate", [("sdpa_ablated", True), ("flash_l0", False)])
def test_unet_step_matches_the_jax_tool(run, ablate, monkeypatch):
    """The tool's step (zero latents, t = 981, labels of ones, batch 2)
    against ``apply_unet``; with ``ablate`` both replace attention's core
    by v, as the JAX tool does."""
    params = numpy_params(init_unet, JaxUNetConfig(**UNET), 0)
    unet = UNet2DConditionModel(tcfg.UNetConfig(**UNET))
    unet.load_state_dict(from_jax_params(unet=params)["unet"], strict=True)
    x, t, lbl = np.zeros((2, 4, 16, 8), np.float32), np.full((2,), 981), np.ones((2, 8), np.float32)
    if ablate:
        monkeypatch.setattr(jax_nn, "sdpa", lambda q, k, v, *a, **kw: v)
    cfg = JaxUNetConfig(**UNET)
    # a fresh function to jit: jit's cache is keyed by the function, and the ablated trace must not be reused
    step = jax.jit(lambda p, x_, t_, l_: apply_unet(p, cfg, x_, t_, class_labels=l_))
    ref = np.asarray(step(params, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t), jnp.asarray(lbl)))
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention", lambda q, k, v: calls.append(q.shape) or real(q, k, v))
    got = bench_unet_step.step_output(unet.eval(), torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(lbl), run)
    np.testing.assert_allclose(got.numpy(), ref.transpose(0, 3, 1, 2), atol=1e-4)
    assert len(calls) == (0 if ablate else 6)  # level 0: attn1 + attn2 of 1 down + 2 up transformers
    assert np.abs(ref).max() > 1e-2


def test_bench_train_step_sections(mods, capsys):
    r = bench_train_step.bench_one(mods, 2, TOKENS, device="cpu", warm=1, timed=1, dtype=F32, mel=MEL)
    assert set(r) == {"batch", "remat", "flash", "s", "samples_per_s", "tflops", "mfu", "loss"} and math.isfinite(r["loss"])
    rows = bench_train_step.sweep(mods, TOKENS, flash=False, device="cpu", cases=((2, True),), warm=1, timed=1,
                                  dtype=F32, mel=MEL)
    assert [(x["batch"], x["remat"], x["flash"]) for x in rows] == [(2, True, False)]
    assert "train step b= 2 remat=1" in capsys.readouterr().out
    d = bench_train_step.bench_distill(mods, 2, TOKENS, device="cpu", warm=1, timed=1, dtype=F32, mel=MEL)
    assert set(d) == {"batch", "s", "samples_per_s", "loss"} and math.isfinite(d["loss"])
    assert fa._MIN_TOKENS == 2048


def test_bench_pipeline_tail(mods, capsys):
    out = bench_pipeline_tail.bench(mods, "cpu", seconds=SECONDS, tokens=TOKENS, warm=1, timed=1, dtype=F32)
    assert _last_json(capsys)["stages"].keys() == out["stages"].keys() == {"text_encode", "vae_decode", "vocoder_fp32",
                                                                            "vocoder_bf16"}
    assert out["stages"]["vocoder_fp32"]["finite"] and out["stages"]["vocoder_fp32"]["k2_launches_per_call"] == 0
    assert "route_from" not in vars(mods.vocoder)  # the plain-stage patch is undone


def test_bench_vocoder_mrf(mods, capsys):
    recs = bench_vocoder_mrf.bench(mods.vocoder, batch=2, device="cpu", frames=8, warm=1, timed=1)
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [r["variant"] for r in recs] == [x["variant"] for x in lines][: len(recs)]
    assert [r["variant"] for r in recs[:2]] == ["plain", "fused_mrf"] and all(r["finite"] for r in recs[:2])
    stages = bench_vocoder_mrf.late_stages(mods.vocoder, 8)
    assert len(recs) == 2 + 2 * len(stages) and all(r["card"] == "cpu" for r in lines)


def test_bench_a2a_steps_run_as_in_the_jax_tool(mods, capsys):
    out = bench_a2a.bench(mods, "cpu", strengths=(1.0, 0.5), steps=4, iters=1, seconds=SECONDS, tokens=TOKENS, dtype=F32)
    assert _last_json(capsys)["results"] == json.loads(json.dumps(out["results"]))
    for r in out["results"]:  # tools/bench_a2a.py's count
        steps, s = 4, r["strength"]
        assert r["steps_run"] == steps - max(steps - min(int(steps * s), steps), 0) and r["finite"]


def test_bench_guidance_interval_counts_cfg_steps_as_the_jax_tool(mods, capsys):
    out = bench_guidance_interval.bench(mods, "cpu", steps=4, iters=1, seconds=SECONDS, tokens=TOKENS, dtype=F32)
    assert [r["interval"] for r in _last_json(capsys)["results"]] == [None, [0.05, 0.65], [0.1, 0.5]]
    for steps in (4, 25, 50):
        ts = np.asarray(jax_timesteps(JaxDDIMConfig(), steps))
        for gi in ((0.05, 0.65), (0.1, 0.5), (0.0, 1.0)):
            want = int(np.sum((ts >= gi[0] * 999) & (ts <= gi[1] * 999)))
            assert bench_guidance_interval.cfg_steps(mods, steps, gi) == want
    assert all(r["finite"] for r in out["results"])
    assert bench_guidance_interval.parse_interval("0.1:0.5") == (0.1, 0.5)


def test_bench_longform(mods, capsys):
    out = bench_longform.bench(mods, "cpu", seconds=0.16, steps=2, window_seconds=SECONDS, iters=1, tokens=TOKENS, dtype=F32)
    assert [r["mode"] for r in _last_json(capsys)["results"]] == ["full", "windowed"]
    assert all(r["finite"] and r["s_per_audio_second"] == r["s_per_clip"] / 0.16 for r in out["results"])


def test_check_perf_passes_and_fails_by_its_thresholds(mods, capsys):
    sizes = dict(seconds=SECONDS, steps=2, tokens=TOKENS, mel=MEL)
    out = check_perf.check(mods, "cpu", serving=True, thresholds={"unet_step_ms": 1e9}, **sizes)
    assert out["ok"] and out["failures"] == [] and _last_json(capsys)["ok"]
    assert set(out["results"]) == {"unet_step_ms", "unet_step_device_ms", "unet_step_k1_launches", "pipeline_s_per_clip",
                                   "serving_s_per_clip_b4", "train_step_b2_ms", "train_step_b2_device_ms"}
    bad = check_perf.check(mods, "cpu", pipeline=False, train=False, thresholds={"unet_step_ms": 0.0}, **sizes)
    assert not bad["ok"] and bad["failures"][0].startswith("unet_step_ms")


def test_check_perf_thresholds_are_the_cards_own():
    thr = check_perf.load_thresholds()
    assert set(thr) == {"unet_step_ms", "unet_step_device_ms", "pipeline_s_per_clip", "serving_s_per_clip_b4",
                        "train_step_b2_ms", "train_step_b2_device_ms"}
    with open(check_perf.THRESHOLDS) as f:
        comment = json.load(f)["_comment"]
    assert "H100" in comment and " W" in comment


def test_quality_proximity_tiny(capsys):
    out = quality_proximity.run("tiny", "cpu")
    assert _last_json(capsys)["width"] == "tiny" and out["vocoder_gain"] > 0
    paths = ["gi50", "dpmpp3", "lcm2", "windowed"]
    for k in paths + ["anchor_diffseed"]:
        assert -1.0 <= out[f"clap_cos_{k}"] <= 1.0 and -1.0 <= out[f"mel_corr_{k}"] <= 1.0
    # the anchor (another seed) reads farther from ddim50 than every fast path
    assert all(out[f"mel_corr_{k}"] > out["mel_corr_anchor_diffseed"] for k in paths)


@pytest.mark.slow
def test_quality_proximity_tiny_matches_the_jax_tool(monkeypatch, capsys):
    """The JAX tool's ``--width tiny --cpu`` run in this process against the
    port's ``proximity`` on the JAX tool's own modules (caught as its
    ``random_modules`` makes them, before its gain calibration), init noise
    (``init_noise`` of its rng and of the anchor's), lcm draws
    (``fold_in(rng2, step)``), gain probe (``PRNGKey(7)``) and CLAP tower:
    every cosine and correlation within 1e-4 (the JAX line rounds them to
    1e-6), the gain within 1e-4 relative beyond the JAX line's rounding to
    0.01 (fp32 on both sides, in another order of summation)."""
    import importlib

    from audioldm_tpu.models import clap_audio as jax_clap
    from tools import quality_proximity as jax_tool

    jax_pg = importlib.import_module("audioldm_tpu.pipeline.generate")  # the package's name `generate` is the function

    caught = {}
    make_modules, make_clap = jax_pg.random_modules, jax_clap.init_clap_audio

    def modules_(*a, **kw):
        caught["mods"] = m = make_modules(*a, **kw)
        caught["vocoder"] = dict(m.vocoder)
        return m

    monkeypatch.setattr(jax_pg, "random_modules", modules_)
    monkeypatch.setattr(jax_clap, "init_clap_audio", lambda *a, **kw: caught.setdefault("clap", make_clap(*a, **kw)))
    monkeypatch.setattr(sys, "argv", ["quality_proximity.py", "--width", "tiny", "--cpu"])
    jax_tool.main()
    ref = _last_json(capsys)

    jm = caught["mods"]
    mods = random_modules(seed=0, device="cpu", **TINY)
    sds = from_jax_params(unet=jm.unet, vae=jm.vae, text_encoder=jm.text_encoder, vocoder=caught["vocoder"])
    for name, sd in sds.items():
        getattr(mods, name).load_state_dict(sd, strict=True)
    clap = quality_proximity.clap_tower(quality_proximity.TINY_CLAP, 0, "cpu")
    clap.load_state_dict(from_jax_params(clap_audio=caught["clap"])["clap_audio"], strict=True)
    secs, steps, dpm, lcm, win, _ = quality_proximity.WIDTHS["tiny"]
    nchw = lambda a: torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2).contiguous()
    lat, rng2 = jax_pg.init_noise(jm, jax.random.PRNGKey(0), 1, secs)
    anchor, _ = jax_pg.init_noise(jm, jax.random.PRNGKey(1000), 1, secs)
    shape = np.asarray(lat).shape
    lcm_draws = [nchw(jax.random.normal(jax.random.fold_in(rng2, i), shape, jnp.float32)) for i in range(lcm)]
    mel_shape = (1, shape[1] * 4, jm.vocoder_cfg.model_in_dim)  # the decoded mel [B, T, F] (the VAE upsamples 4x here)
    probe = torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(7), mel_shape + (1,), jnp.float32))[..., 0])
    got = quality_proximity.proximity(mods, clap, "cpu", secs, steps, dpm, lcm, win, 0, F32,
                                      latents={"seed": nchw(lat), "anchor": nchw(anchor)},
                                      draws={f"lcm{lcm}": {"step_noise": lcm_draws}}, probe=probe)
    assert abs(got["vocoder_gain"] - ref["vocoder_gain"]) <= 0.005 + 1e-4 * ref["vocoder_gain"]  # the JAX line rounds to 0.01
    keys = [k for k in ref if k.startswith(("clap_cos_", "mel_corr_"))]
    assert len(keys) == 10 and set(keys) <= set(got)
    for k in keys:
        assert abs(got[k] - ref[k]) <= 1e-4, (k, got[k], ref[k])


def test_profile_pipeline_and_read_trace(mods, tmp_path, capsys):
    out = profile_pipeline.profile(mods, "cpu", str(tmp_path / "prof"), steps=2, seconds=SECONDS, tokens=TOKENS, dtype=F32)
    assert os.path.exists(tmp_path / "prof" / "trace.json") and out["finite"]
    assert [r["name"] for r in out["host_top_level"]][:1] == ["denoise"]
    assert {r["name"] for r in out["host_top_level"]} == {"text", "noise", "denoise", "vae_decode", "vocoder"}
    assert _last_json(capsys)["tool"] == "read_trace"


def test_read_trace_ranks_kernels_and_top_level_ranges(tmp_path, capsys):
    """Device kernels by total time; host ranges only where no range of the
    same thread contains them; the busy share is the union of kernels over
    the span."""
    ev = lambda name, cat, ts, dur, tid=1: {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid}
    trace = {"traceEvents": [
        ev("outer", "user_annotation", 0, 100), ev("aten::mm", "cpu_op", 10, 20), ev("other", "cpu_op", 120, 30),
        ev("side", "cpu_op", 5, 10, tid=2),
        ev("k_a", "kernel", 20, 10, tid=7), ev("k_a", "kernel", 25, 10, tid=8), ev("k_b", "kernel", 60, 30, tid=7),
        ev("memcpy", "gpu_memcpy", 95, 5, tid=7), {"ph": "i", "name": "marker", "ts": 3},
    ]}
    (tmp_path / "trace.json").write_text(json.dumps(trace))
    out = read_trace.summarize(str(tmp_path), top=10)
    assert [(r["name"], r["count"], r["ms"]) for r in out["device_kernels"]] == [
        ("k_b", 1, 0.03), ("k_a", 2, 0.02), ("memcpy", 1, 0.005)]
    assert [(r["name"], r["count"]) for r in out["host_top_level"]] == [("outer", 1), ("other", 1), ("side", 1)]
    assert out["span_ms"] == 0.15 and out["device_busy_share"] == pytest.approx(50 / 150)
    assert _last_json(capsys)["device_events"] == 4
    with pytest.raises(FileNotFoundError):
        read_trace.find_trace(str(tmp_path / "none"))


def test_bench_matmul(capsys):
    out = bench_matmul.bench(((16, 8, 32), (8, 8, 8)), "cpu", iters=1)
    assert _last_json(capsys)["results"] == out["results"] and out["dtype"] == "bfloat16"
    assert [r["shape"] for r in out["results"]] == [[16, 8, 32], [8, 8, 8]] and all(r["ms"] is None for r in out["results"])


@pytest.mark.parametrize("k,dil", [(3, 1), (7, 3), (11, 5)])
def test_conv1d_smallc_matches_the_jax_tool(k, dil):
    """The port's direct and im2col convolutions against the JAX tool's
    (``NWC``, ``WIO``) on the same input and weights, fp32: 1e-5."""
    from tools import bench_conv1d_smallc as jax_conv

    r = np.random.default_rng(k)
    x, w = r.standard_normal((2, 96, 8)).astype(np.float32), (0.05 * r.standard_normal((k, 8, 8))).astype(np.float32)
    ref = np.asarray(jax_conv.conv_direct(jnp.asarray(x), jnp.asarray(w), dil)).transpose(0, 2, 1)
    xt, wt = torch.from_numpy(x.transpose(0, 2, 1).copy()), torch.from_numpy(w.transpose(2, 1, 0).copy())
    for fn, jfn in ((bench_conv1d_smallc.conv_direct, jax_conv.conv_direct), (bench_conv1d_smallc.conv_im2col,
                                                                               jax_conv.conv_im2col)):
        np.testing.assert_allclose(fn(xt, wt, dil).numpy(), ref, atol=1e-5)
        np.testing.assert_allclose(np.asarray(jfn(jnp.asarray(x), jnp.asarray(w), dil)).transpose(0, 2, 1), ref, atol=1e-5)


def test_bench_conv1d_smallc(capsys):
    recs = bench_conv1d_smallc.bench(((96, 8, 7, 3), (64, 16, 3, 1)), "cpu", iters=1)
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [x["dtype"] for x in lines] == ["float32", "float32", "bfloat16", "bfloat16"] and len(recs) == 4
    assert all(r["direct_ms"] is None and r["max_abs_err"] < 1e-5 for r in recs)
    assert torch.backends.cudnn.allow_tf32  # restored


@pytest.mark.parametrize("stage", bench_compile.STAGES)
def test_bench_compile_stage_in_process(stage):
    r = bench_compile.stage(stage, "tiny", "cpu", steps=2)
    assert r["stage"] == stage and r["first_s"] > 0 and r["second_s"] > 0 and r["init_s"] > 0


@pytest.mark.slow
def test_bench_compile_runs_each_stage_in_a_fresh_process(capsys):
    out = bench_compile.bench("tiny", "cpu", steps=2)
    assert list(out["stages"]) == list(bench_compile.STAGES) and "build" not in out
    assert _last_json(capsys)["tool"] == "bench_compile"


@pytest.mark.parametrize("tool", [bench_unet_step, bench_train_step, bench_pipeline_tail, bench_vocoder_mrf, bench_a2a,
                                  bench_guidance_interval, bench_longform, check_perf, quality_proximity,
                                  profile_pipeline, bench_compile, bench_matmul, bench_conv1d_smallc])
def test_tools_need_a_gpu_unless_asked_for_the_cpu(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert tool.main([]) == 1
    assert "no CUDA GPU" in capsys.readouterr().err
