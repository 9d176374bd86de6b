"""The port's ``cli distill`` on the CPU at the tiny geometry of
tests/test_torch_port_pipeline.py: the tiny HF-layout checkpoint that the
JAX package writes there, the captioned corpus of
tests/test_torch_port_train_cli.py, fp32.

``cli distill --device cpu`` is held to ``distill_step`` driven by hand on
the port's ``DataPipeline`` batches with the same seeds (bit for bit), its
PEFT files to the JAX package's export names, and its EMA adapter is served
by ``cli generate --scheduler lcm --lora OUT/model.safetensors``.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from audioldm_tpu.config import LoRAConfig as JaxLoRAConfig
from audioldm_tpu.lora import export_peft_state_dict as jax_export_peft
from audioldm_tpu.lora import init_lora as jax_init_lora
from audioldm_tpu_torch import cli
from audioldm_tpu_torch import config as tcfg
from audioldm_tpu_torch.ckpt import read_safetensors, write_safetensors
from audioldm_tpu_torch.data import AudioCaptionDataset, DataPipeline, load_tokenizer
from audioldm_tpu_torch.data.wavio import read_wav
from audioldm_tpu_torch.lora import LoRAAdapters, export_peft_state_dict, import_peft_state_dict, init_lora, merge_lora
from audioldm_tpu_torch.pipeline import generate as pg
from audioldm_tpu_torch.train import to_device_batch
from audioldm_tpu_torch.train.distill import add_uncond_tokens, distill_modules, distill_step, init_distill_state
from test_torch_port_pipeline import SECONDS, checkpoint, jax_modules  # noqa: F401 (fixtures)
from test_torch_port_train_cli import _yaml, corpus  # noqa: F401 (fixture)

RUN = {  # the tiny geometry: 16 mel frames of 8 bins -> latents [B, 4, 8, 4]
    "lora": {"r": 2, "lora_alpha": 2},
    "train": {"train_batch_size": 2, "mixed_precision": None, "learning_rate": "1.0e-3", "seed": 3},
    "mel": {"n_mel": 8, "duration": 0.16},
    "data": {"prefetch": 2},
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


def _distill(checkpoint, corpus, out, *extra):  # noqa: F811
    return cli.main(["distill", "--checkpoint", checkpoint, "--config", _yaml(out + ".yaml", RUN), "--dataset", corpus,
                     "--output", out, "--log-every", "1", "--device", "cpu", *extra])


def _by_hand(checkpoint, corpus, steps, w, teacher=None):  # noqa: F811
    """``distill_step`` driven by hand as ``cli distill`` drives it."""
    mods = pg.AudioLDMModules.from_checkpoint(checkpoint, device="cpu")
    if teacher is not None:
        merge_lora(mods.unet, teacher, tcfg.LoRAConfig(r=2, lora_alpha=2.0))
    distill_modules(mods)
    tok = load_tokenizer(os.path.join(checkpoint, "tokenizer"))
    lcfg = tcfg.LoRAConfig(r=2, lora_alpha=2.0)
    train = tcfg.TrainConfig(train_batch_size=2, mixed_precision=None, learning_rate=1e-3, seed=3, max_train_steps=steps)
    pipe = DataPipeline(AudioCaptionDataset(corpus), tok, tcfg.MelConfig(n_mel=8, duration=0.16), device="cpu")
    state = init_distill_state(init_lora(mods.unet, lcfg, torch.Generator().manual_seed(3)), train)
    gen = torch.Generator().manual_seed(4)
    batches = pipe.batches(2, np.random.default_rng(3), epochs=2)
    losses = []
    for _, batch in zip(range(steps), batches):
        b = to_device_batch(add_uncond_tokens({k: batch[k] for k in ("log_mel_spec", "input_ids", "attention_mask")}, tok),
                            "cpu")
        state, metrics = distill_step(state, mods, b, lcfg, w=w, generator=gen)
        losses.append(metrics["loss"].item())
    return state, losses


def _equal(a: LoRAAdapters, b: LoRAAdapters) -> bool:
    return [p for p, _, _ in a.items()] == [p for p, _, _ in b.items()] and all(
        torch.equal(x1, x2) and torch.equal(y1, y2) for (_, x1, y1), (_, x2, y2) in zip(a.items(), b.items()))


def test_cli_distill_equals_distill_step_by_hand(checkpoint, corpus, jax_modules, tmp_path, capsys):  # noqa: F811
    """``--w 2.0,3.0`` (a range), 3 steps, ``--dp 1`` accepted: the EMA and
    the student equal the hand-driven steps bit for bit, one finite
    ``distill_loss`` line a step, and the two PEFT files hold them under the
    JAX package's export names."""
    out = str(tmp_path / "out")
    state = _distill(checkpoint, corpus, out, "--max-steps", "3", "--w", "2.0,3.0", "--dp", "1")
    printed = capsys.readouterr().out
    assert f"distilled 3 steps -> {out}/model.safetensors; final loss" in printed and state.step == 3
    hand, losses = _by_hand(checkpoint, corpus, 3, (2.0, 3.0))
    assert _equal(state.lora, hand.lora) and _equal(state.ema_lora, hand.ema_lora)
    assert not _equal(state.lora, state.ema_lora) and any(bool(b.any()) for _, _, b in state.ema_lora.items())

    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert [r["distill_loss"] for r in recs] == pytest.approx(losses, rel=1e-6)
    assert all(np.isfinite(r["grad_norm"]) and r["grad_norm"] > 0 for r in recs)

    want_keys = set(jax_export_peft(jax_init_lora(jax.random.PRNGKey(0), jax_modules.unet, JaxLoRAConfig(r=2, lora_alpha=2))))
    for name, adapters in (("model", hand.ema_lora), ("student", hand.lora)):
        sd = read_safetensors(os.path.join(out, f"{name}.safetensors"))
        assert set(sd) == want_keys and len(sd) == 32
        ref = export_peft_state_dict(adapters)
        assert all(torch.equal(sd[k], ref[k]) for k in ref), name
        back, rank = import_peft_state_dict(sd)
        assert rank == 2 and _equal(back, adapters)


def test_cli_distill_merges_the_teacher_lora(checkpoint, corpus, tmp_path, capsys):  # noqa: F811
    """``--teacher-lora``: student, teacher and target share the base UNet
    with the PEFT adapter merged (scale alpha/r = 1), as by hand; the result
    differs from distilling the unmerged base."""
    gen = torch.Generator().manual_seed(11)
    mods = pg.AudioLDMModules.from_checkpoint(checkpoint, device="cpu")
    teacher = init_lora(mods.unet, tcfg.LoRAConfig(r=2, lora_alpha=2.0), gen)
    with torch.no_grad():
        for b in teacher.b.values():
            b.copy_(0.3 * torch.randn(b.shape, generator=gen))
    path = str(tmp_path / "teacher.safetensors")
    write_safetensors(path, export_peft_state_dict(teacher))
    state = _distill(checkpoint, corpus, str(tmp_path / "out"), "--max-steps", "1", "--teacher-lora", path)
    hand, _ = _by_hand(checkpoint, corpus, 1, 2.5, teacher=teacher)
    plain, _ = _by_hand(checkpoint, corpus, 1, 2.5)
    assert _equal(state.lora, hand.lora) and _equal(state.ema_lora, hand.ema_lora)
    assert not _equal(state.lora, plain.lora)


def test_cli_generate_lcm_serves_the_distilled_adapter(checkpoint, corpus, tmp_path, capsys):  # noqa: F811
    """The user's path: distill, then 4-step LCM generation with the EMA
    adapter merged at load; equal to ``generate`` with the adapter merged
    by hand."""
    out = str(tmp_path / "out")
    state = _distill(checkpoint, corpus, out, "--max-steps", "2")
    wav_path = str(tmp_path / "lcm.wav")
    cli.main(["generate", "--checkpoint", checkpoint, "--prompt", "hip hop music", "--scheduler", "lcm", "--steps", "4",
              "--seconds", str(SECONDS), "--lora", os.path.join(out, "model.safetensors"), "--fp32", "--device", "cpu",
              "--output", wav_path])
    printed = capsys.readouterr().out
    assert "merged LoRA" in printed and f"wrote {wav_path}" in printed
    wav, sr = read_wav(wav_path)
    assert sr == 16000 and wav.shape == (int(SECONDS * 16000),) and np.abs(wav).max() > 0

    mods = pg.AudioLDMModules.from_checkpoint(checkpoint, device="cpu")
    merge_lora(mods.unet, state.ema_lora, tcfg.LoRAConfig(r=2, lora_alpha=2.0))
    tok = load_tokenizer(os.path.join(checkpoint, "tokenizer"))
    enc, unc = tok(["hip hop music"]), tok([""])
    ref = pg.generate(mods, enc["input_ids"], enc["attention_mask"], unc["input_ids"], unc["attention_mask"], seed=0,
                      num_inference_steps=4, audio_length_in_s=SECONDS, guidance_scale=2.5, dtype=torch.float32,
                      scheduler="lcm", device="cpu")[0].numpy()
    np.testing.assert_allclose(wav, np.round(np.clip(ref, -1, 1) * 32767) / 32767, atol=1.5 / 32767)


@pytest.mark.parametrize("flags,message", [(["--dp", "2"], "parallelism"), (["--w", "2,x"], "--w expects"),
                                           (["--w", "3,2"], "LO <= HI")])
def test_cli_distill_refuses_bad_flags(flags, message):
    with pytest.raises(SystemExit, match=message):
        cli.main(["distill", "--checkpoint", "unused", "--dataset", "unused", "--output", "unused", "--device", "cpu"]
                 + flags)


def test_cli_distill_needs_a_gpu_unless_asked_for_cpu(checkpoint, corpus, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main(["distill", "--checkpoint", checkpoint, "--dataset", corpus, "--output", str(tmp_path)])


def test_run_config_of_the_tiny_yaml(tmp_path):
    run = tcfg.RunConfig.from_yaml(_yaml(str(tmp_path / "run.yaml"), RUN))
    assert run.lora == tcfg.LoRAConfig(r=2, lora_alpha=2.0) and run.train.mixed_precision is None
    assert dataclasses.replace(run.train, max_train_steps=3).learning_rate == 1e-3 and run.mel.target_length == 16
