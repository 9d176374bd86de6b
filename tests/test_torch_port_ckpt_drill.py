"""The port's checkpoint drill (audioldm_tpu_torch/tools/ckpt_drill.py).

Tier 1: the drill's gates (``compare``) on synthetic waveforms, its int16
model against the port's wav writer and reader, and its init latents
against the pipeline's.

Slow: the independent half of the drill at the quarter-width full
geometry and a 2.56 s clip. The checkpoint is written by the JAX package's
drill (``tools/ckpt_drill.py build_checkpoint``): raw-torch oracle UNet and
VAE, transformers' ``ClapTextModelWithProjection`` and ``SpeechT5HifiGan``,
in the exact ``cvssp/audioldm-s-full-v2`` layout. The port's ``cli
generate --device cpu --fp32`` runs on it as a subprocess, and its waveform
is held to that drill's raw-torch trajectory (``torch_trajectory``) fed the
port's init latents, with the drill's CPU fp32 bound.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from audioldm_tpu_torch import config as tcfg
from audioldm_tpu_torch.data.wavio import read_wav, write_wav
from audioldm_tpu_torch.pipeline import generate as pg
from audioldm_tpu_torch.tools import ckpt_drill as drill
from test_torch_port_pipeline import TEXT, UNET, VAE, VOC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = drill.BOUNDS[("cpu", "fp32")]


def _tone(n=16000, amp=0.3, seed=0):
    t = np.arange(n) / 16000.0
    rng = np.random.default_rng(seed)
    return (amp * np.sin(2 * np.pi * 440.0 * t) + 0.05 * amp * rng.standard_normal(n)).astype(np.float32)


def _round_trip(tmp_path, wav):
    path = str(tmp_path / "x.wav")
    write_wav(path, wav, 16000)
    return read_wav(path)[0]


def test_quantize_is_the_wav_files_round_trip(tmp_path):
    wav = np.concatenate([_tone(), np.array([1.7, -2.0, 0.0, 1.0 / 65534], np.float32)])
    np.testing.assert_array_equal(_round_trip(tmp_path, wav), drill.quantize(wav))


def test_compare_gates(tmp_path):
    """Each gate fails on its own: a waveform equal to the reference after
    int16 passes; a shift over the bound fails max|d|; a spread of small
    differences fails mean|d|; small differences on a quiet signal fail the
    correlation under a loose bound; silence and a short waveform fail."""
    ref = _tone()
    cli = _round_trip(tmp_path, ref)
    ok = drill.compare(cli, ref, BOUND)
    assert ok["pass"] and ok["max_abs_diff"] == 0.0 and ok["corr"] == 1.0 and not ok["vacuous"]
    cases = {
        "max": cli + np.where(np.arange(cli.size) == 500, 2 * BOUND, 0.0).astype(np.float32),
        "mean": cli + 0.9 * BOUND * np.sign(np.sin(np.arange(cli.size))).astype(np.float32),
        "corr": _round_trip(tmp_path, ref + 0.06 * np.sign(_tone(seed=1, amp=1.0))),
        "silence": np.zeros_like(cli),
        "short": cli[:-1],
    }
    bounds = {"corr": 0.2}
    got = {name: drill.compare(wav, ref, bounds.get(name, BOUND)) for name, wav in cases.items()}
    assert not any(r["pass"] for r in got.values())
    assert got["max"]["max_abs_diff"] > BOUND and got["max"]["mean_abs_diff"] < BOUND / 3 and got["max"]["corr"] > 0.999
    assert got["mean"]["max_abs_diff"] <= BOUND < 3 * got["mean"]["mean_abs_diff"]
    assert got["corr"]["max_abs_diff"] <= 0.2 and got["corr"]["mean_abs_diff"] <= 0.2 / 3 and got["corr"]["corr"] < 0.999
    assert got["silence"]["vacuous"] and not got["short"]["same_length"]


def test_cli_init_latents_are_the_pipelines():
    torch.set_num_threads(1)
    mods = pg.random_modules(0, tcfg.UNetConfig(**UNET), tcfg.VAEConfig(**VAE), tcfg.ClapTextConfig(**TEXT),
                             tcfg.VocoderConfig(**VOC), device="cpu")
    lat = drill.cli_init_latents(mods, 5, 0.04)
    assert torch.equal(lat, pg.init_noise(mods, 5, 1, 0.04)) and tuple(lat.shape) == (1, 4, 80, 4)
    assert drill.geometry("quarter")["unet_cfg"].block_out_channels == (32, 64, 96, 160)


@pytest.mark.slow
def test_quarter_width_independent_checkpoint_through_the_port_cli(tmp_path):
    spec = importlib.util.spec_from_file_location("jax_ckpt_drill", os.path.join(REPO, "tools", "ckpt_drill.py"))
    jdrill = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jdrill)
    ckpt, wav_path, seconds = str(tmp_path / "ckpt"), str(tmp_path / "port.wav"), 2.56
    bundle = jdrill.build_checkpoint(ckpt, "quarter", seed=0)
    drill.run_cli(ckpt, wav_path, "cpu", True, seconds)
    wav, sr = read_wav(wav_path)
    lat = drill.cli_init_latents(pg.AudioLDMModules.from_checkpoint(ckpt, device="cpu"), 0, seconds)
    ref = jdrill.torch_trajectory(bundle, drill.PROMPT, "", drill.STEPS, seconds, drill.GUIDANCE,
                                  lat.numpy().transpose(0, 2, 3, 1), ckpt)
    res = drill.compare(wav, ref, BOUND)
    assert sr == 16000 and res["samples"] == int(seconds * 16000)
    assert res["pass"], res
