"""The port's ``cli train`` and what it stands on (``RunConfig``,
``MetricLogger``, ``train/validation.py`` (its CLAP scores in
tests/test_torch_port_eval_cli.py),
``save_audioldm_checkpoint``, ``train.to_device_batch``) against the JAX
package, fp32 on the CPU at the tiny geometry of
tests/test_torch_port_pipeline.py.

``cli train --device cpu`` runs on the tiny HF-layout checkpoint that the JAX
package writes there, over a folder of wavs and captions the test writes; its
adapters are held to ``Trainer.fit`` driven by hand on the port's
``DataPipeline`` batches with the same seeds. Validation is held to the JAX
``log_validation`` given the JAX init latents, at the multi-step 2e-3.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioldm_tpu.config import LoRAConfig as JaxLoRAConfig
from audioldm_tpu.config import RunConfig as JaxRunConfig
from audioldm_tpu.lora import init_lora as jax_init_lora
from audioldm_tpu.pipeline.generate import init_noise as jax_init_noise
from audioldm_tpu.train.validation import log_validation as jax_log_validation
from audioldm_tpu.utils.logging import MetricLogger as JaxMetricLogger
from audioldm_tpu_torch import cli
from audioldm_tpu_torch import config as tcfg
from audioldm_tpu_torch.ckpt import load_audioldm_checkpoint, lora_from_jax, save_audioldm_checkpoint
from audioldm_tpu_torch.data import AudioCaptionDataset, DataPipeline, load_tokenizer
from audioldm_tpu_torch.data.wavio import read_wav, write_wav
from audioldm_tpu_torch.lora import init_lora
from audioldm_tpu_torch.pipeline import generate as pg
from audioldm_tpu_torch.train import Trainer, to_device_batch
from audioldm_tpu_torch.train.validation import log_validation, spectrogram_image
from audioldm_tpu_torch.utils import MetricLogger
from test_torch_port_pipeline import SECONDS, checkpoint, jax_modules, port_modules  # noqa: F401 (fixtures)
from tests.test_serve import DummyTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = {  # the tiny geometry: 16 mel frames of 8 bins -> latents [B, 4, 8, 4]
    "validation_prompt": "hip hop music", "num_validation_images": 1,
    "lora": {"r": 2, "lora_alpha": 2},
    "train": {"train_batch_size": 2, "checkpointing_steps": 1000, "mixed_precision": None, "learning_rate": "1.0e-3",
              "seed": 3},
    "mel": {"n_mel": 8, "duration": 0.16},
    "data": {"prefetch": 2, "add_ons": ["extract_drum_beat"]},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: at these tiny sizes a pool of threads only waits
    for its members, and slows by orders of magnitude when test processes
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _yaml(path, d):
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return str(path)


# -- the run config ----------------------------------------------------------


def test_run_config_from_the_default_yaml_matches_jax():
    path = os.path.join(REPO, "configs", "default.yaml")
    ours, theirs = tcfg.RunConfig.from_yaml(path), JaxRunConfig.from_yaml(path)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.train.betas == (0.9, 0.999) and isinstance(ours.train.eps, float)
    assert dataclasses.asdict(tcfg.RunConfig()) == dataclasses.asdict(JaxRunConfig())


def test_run_config_overrides_match_jax(tmp_path):
    raw = {**RUN, "output_dir": "elsewhere", "validation_epochs": 3,
           "train": {**RUN["train"], "betas": [0.8, 0.99], "eps": "1.0e-06", "not_a_key": 1},
           "mel": {"n_mel": 8, "duration": 0.16, "bogus": True},
           "data": {"add_ons": ["extract_drum_beat"], "freqm": 4, "unknown": 0},
           "wandb": {"group": "g", "tags": ["a"]}}
    path = _yaml(tmp_path / "run.yaml", raw)
    ours, theirs = tcfg.RunConfig.from_yaml(path, dataset_hub_id="x"), JaxRunConfig.from_yaml(path, dataset_hub_id="x")
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.train.betas == (0.8, 0.99) and ours.train.eps == 1e-6 and ours.train.learning_rate == 1e-3
    assert ours.data.add_ons == ("extract_drum_beat",) and ours.data.freqm == 4 and ours.dataset_hub_id == "x"
    assert ours.train.mixed_precision is None and ours.mel.target_length == 16
    empty = _yaml(tmp_path / "empty.yaml", {})
    assert dataclasses.asdict(tcfg.RunConfig.from_yaml(empty)) == dataclasses.asdict(JaxRunConfig.from_yaml(empty))


# -- the metric logger -------------------------------------------------------


def test_metric_logger_lines_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal(1600) * 0.3).astype(np.float32)
    records = [({"train_loss": 0.5, "lr": np.float32(1e-4), "epoch": 0, "n": np.int64(3), "note": "text"}, 1),
               ({"loss": float("nan"), "bad": float("inf"), "good": 2.0}, 2)]
    paths = {}
    for name, cls in (("port", MetricLogger), ("jax", JaxMetricLogger)):
        lg = cls(str(tmp_path / name))
        for metrics, step in records:
            lg.log(metrics, step=step)
        paths[name] = (lg.log_audio("val/0", wav, 16000, step=2), lg.log_image("val_mel/0", b"\x89PNG-bytes", step=2))
        lg.close()
    lines = {}
    for name in paths:
        with open(tmp_path / name / "metrics.jsonl") as f:
            lines[name] = [json.loads(line) for line in f]  # strict JSON: no bare NaN
        for rec in lines[name]:
            assert isinstance(rec.pop("time"), float)
    assert lines["port"] == lines["jax"]
    assert lines["port"][1] == {"step": 2, "loss": None, "bad": None, "good": 2.0}
    for pa, ja in zip(paths["port"], paths["jax"]):  # the wav, then the png
        assert os.path.basename(pa) == os.path.basename(ja) and open(pa, "rb").read() == open(ja, "rb").read()
    assert os.path.basename(paths["port"][1]) == "val_mel_0_step2.png"


def test_metric_logger_without_wandb_or_tensorboard_keeps_the_jsonl(tmp_path, capsys, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "wandb", None)  # neither importable
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    lg = MetricLogger(str(tmp_path), use_tensorboard=True, use_wandb=True)
    assert lg._tb is None and lg._wandb is None
    lg.log({"train_loss": 0.25}, step=1)
    lg.close()
    printed = capsys.readouterr().out
    assert "wandb unavailable" in printed and "tensorboard unavailable" in printed
    with open(tmp_path / "metrics.jsonl") as f:
        assert json.loads(f.readline())["train_loss"] == 0.25


# -- validation --------------------------------------------------------------


def test_log_validation_matches_jax(jax_modules, tmp_path):  # noqa: F811
    jlcfg, lcfg = JaxLoRAConfig(r=2, lora_alpha=4), tcfg.LoRAConfig(r=2, lora_alpha=4.0)
    jl = jax_init_lora(jax.random.PRNGKey(1), jax_modules.unet, jlcfg)
    jl = jax.tree.map(lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(2), x.shape), jl)
    kw = dict(num_clips=2, num_inference_steps=2, audio_length_in_s=SECONDS, guidance_scale=2.0, seed=5)
    tok = DummyTokenizer()
    want = jax_log_validation(jax_modules, jl, jlcfg, tok, "hip hop music", dtype=jnp.float32,
                              logger=JaxMetricLogger(str(tmp_path / "jax")), step=4, **kw)
    lat, _ = jax_init_noise(jax_modules, jax.random.PRNGKey(5), 2, SECONDS)
    mods = port_modules(jax_modules)
    got = log_validation(mods, lora_from_jax(jax.tree.map(np.asarray, jl)), lcfg, tok, "hip hop music", dtype=torch.float32,
                         device="cpu",
                         latents=torch.from_numpy(np.array(lat).transpose(0, 3, 1, 2)),
                         logger=MetricLogger(str(tmp_path / "port")), step=4, **kw)
    for k in ("audios", "original_audios"):
        assert got[k].shape == want[k].shape == (2, int(SECONDS * 16000))
        np.testing.assert_allclose(got[k], want[k], atol=2e-3)
    assert np.abs(got["audios"] - got["original_audios"]).max() > 1e-4  # the adapters are felt
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert "validation_mel_0_step4.png" in os.listdir(tmp_path / "port")
    # without a scorer a reference corpus scores nothing (tests/test_torch_port_eval_cli.py scores)
    unscored = log_validation(mods, None, lcfg, tok, "x", ref_audios_16k=[np.zeros(640, np.float32)] * 2, device="cpu", **kw)
    assert set(unscored) == {"audios", "original_audios"}


def test_spectrogram_image_png():
    png = spectrogram_image((np.random.default_rng(0).standard_normal(16000) * 0.3).astype(np.float32))
    assert png[:8] == b"\x89PNG\r\n\x1a\n"


# -- checkpoints -------------------------------------------------------------


def test_save_checkpoint_round_trips_and_loads_in_jax(jax_modules, tmp_path):  # noqa: F811
    from audioldm_tpu.ckpt import load_audioldm_checkpoint as jax_load

    mods = port_modules(jax_modules)
    save_audioldm_checkpoint(str(tmp_path), mods)
    loaded = pg.AudioLDMModules.from_checkpoint(str(tmp_path), device="cpu")
    for name in ("unet", "vae", "text_encoder", "vocoder"):
        a, b = getattr(loaded, name).state_dict(), getattr(mods, name).state_dict()
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert loaded.ddim_cfg == mods.ddim_cfg
    bundle = jax_load(str(tmp_path))
    flat = lambda tree: {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
                         for path, v in jax.tree_util.tree_leaves_with_path(tree)}
    for name in ("unet", "vae", "text_encoder", "vocoder"):
        got, want = flat(bundle["params"][name]), flat(getattr(jax_modules, name))
        assert got.keys() == want.keys(), name
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")
    for name, cfg in (("unet", jax_modules.unet_cfg), ("vae", jax_modules.vae_cfg), ("text_encoder", jax_modules.text_cfg),
                      ("vocoder", jax_modules.vocoder_cfg), ("scheduler", jax_modules.ddim_cfg)):
        assert bundle["configs"][name] == cfg
    # bf16 modules are written in fp32
    mods.to("cpu", torch.bfloat16)
    save_audioldm_checkpoint(str(tmp_path / "bf16"), mods)
    assert load_audioldm_checkpoint(str(tmp_path / "bf16"))["state_dicts"]["unet"]["conv_in.weight"].dtype == torch.float32


def test_to_device_batch_keeps_the_loss_keys_and_numeric_add_ons():
    batch = {"log_mel_spec": torch.zeros(2, 1, 4, 4), "input_ids": np.ones((2, 3), np.int32), "attention_mask": np.ones((2, 3)),
             "waveform": np.zeros((2, 10)), "stft": torch.zeros(2, 4, 2), "random_start": np.zeros(2), "duration": 0.16,
             "sampling_rate": 16000, "text": ["", "x"], "cond_beat_downbeat": np.ones((2, 2, 2), np.float32),
             "names": ["a", "b"]}
    out = to_device_batch(batch, torch.device("cpu"))
    assert set(out) == {"log_mel_spec", "input_ids", "attention_mask", "cond_beat_downbeat"}
    assert all(torch.is_tensor(v) for v in out.values()) and out["log_mel_spec"] is batch["log_mel_spec"]


# -- cli train ---------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """4 captioned clips at 16 and 22.05 kHz, one with a drum-beat sidecar."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(7)
    for i, sr in enumerate((16000, 22050, 16000, 22050)):
        write_wav(str(d / f"clip{i}.wav"), (rng.standard_normal(int(sr * 0.25)) * 0.3).astype(np.float32), sr)
        (d / f"clip{i}.txt").write_text(f"hip hop music {i}")
        (d / f"clip{i}.json").write_text(json.dumps({"sample_rate": sr, "beat": [100 * i, 2000], "downbeat": [2000]}))
    return str(d)


def _train(checkpoint, corpus, out, *extra):  # noqa: F811
    return cli.main(["train", "--checkpoint", checkpoint, "--config", _yaml(os.path.join(out + ".yaml"), RUN),
                     "--dataset", corpus, "--output", out, "--log-every", "1", "--val-clips", "1", "--val-steps", "2",
                     "--val-seconds", str(SECONDS), "--device", "cpu", *extra])


def test_cli_train_equals_fit_by_hand_then_resumes(checkpoint, corpus, tmp_path, capsys):  # noqa: F811
    out = str(tmp_path / "out")
    trainer, state = _train(checkpoint, corpus, out, "--max-steps", "3", "--validate-every", "1")
    printed = capsys.readouterr().out
    assert "done at step 3; final loss" in printed and state.step == 3

    run = tcfg.RunConfig.from_yaml(out + ".yaml")
    mods = pg.AudioLDMModules.from_checkpoint(checkpoint, device="cpu")
    pipe = DataPipeline(AudioCaptionDataset(corpus), load_tokenizer(os.path.join(checkpoint, "tokenizer")), run.mel,
                        add_ons=run.data.add_ons, device="cpu")
    hand = Trainer(mods, run.lora, dataclasses.replace(run.train, max_train_steps=3), str(tmp_path / "hand"), device="cpu")
    st = hand.init_state(init_lora(mods.unet, run.lora, torch.Generator().manual_seed(3)))
    batches = [to_device_batch(b, "cpu") for b in pipe.batches(2, np.random.default_rng(3), epochs=2)]
    assert "cond_beat_downbeat" in batches[0] and batches[0]["log_mel_spec"].shape == (2, 1, 16, 8)
    st, _ = hand.fit(st, iter(batches), torch.Generator().manual_seed(4), max_steps=3)
    for (p, a, b), (p2, a2, b2) in zip(state.lora.items(), st.lora.items()):
        assert p == p2 and torch.equal(a, a2) and torch.equal(b, b2), p
    assert any(bool(b.any()) for _, _, b in state.lora.items())

    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if "train_loss" in r] == [1, 2, 3]
    assert all(np.isfinite(r["train_loss"]) and r["epoch"] == (r["step"] - 1) // 2 for r in recs if "train_loss" in r)
    files = os.listdir(out)
    for name in ("validation_0_step2.wav", "original_validation_0_step2.wav", "validation_mel_0_step2.png"):
        assert name in files
    assert read_wav(os.path.join(out, "validation_0_step2.wav"))[0].shape == (int(SECONDS * 16000),)
    assert os.path.exists(os.path.join(out, "checkpoint-3", "model.safetensors"))
    assert os.path.exists(os.path.join(out, "checkpoints", "step-3.pt"))

    # --dp 1 runs the data-parallel path over a group of one process (gloo on the CPU)
    _, resumed = _train(checkpoint, corpus, out, "--max-steps", "5", "--resume", "--validate-every", "0", "--dp", "1")
    printed = capsys.readouterr().out
    assert "resumed at step 3" in printed and "done at step 5" in printed and resumed.step == 5
    assert os.path.exists(os.path.join(out, "checkpoint-5", "model.safetensors"))


@pytest.mark.parametrize("flags,part", [(["--dp", "2"], "needs 2 processes.*torch.distributed.run")])
def test_cli_train_refuses_flags_of_later_slices(flags, part):
    with pytest.raises(SystemExit, match=part):
        cli.main(["train", "--checkpoint", "unused", "--dataset", "unused", "--device", "cpu"] + flags)


def test_cli_train_needs_a_gpu_unless_asked_for_cpu(checkpoint, corpus, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main(["train", "--checkpoint", checkpoint, "--dataset", corpus, "--output", str(tmp_path)])
