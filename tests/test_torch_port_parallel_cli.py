"""The port's parallel CLI commands under torchrun, two processes over gloo
on the CPU: ``train --dp 2``, ``serve --dp 2 --requests``, ``generate --tp
2`` and ``distill --dp 2``, each held to the same command at world size 1
(in this process) on the tiny checkpoint and corpus of
tests/test_torch_port_train_cli.py; and ``--dp 3`` refused at world size 2
with the torchrun command.

Each parallel run is ``python -m torch.distributed.run --standalone
--nproc-per-node 2 -m audioldm_tpu_torch.cli ...`` (torchrun picks a free
local port), killed and failed after ``TIMEOUT_S``. A data-parallel step on
a global batch of 4 (2 rows a rank) equals the single-process step on the
same batch of 4 (``--batch-size 4``): the same data order and the same
draws, made whole on every rank.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from audioldm_tpu_torch import cli
from audioldm_tpu_torch.ckpt import read_safetensors, write_safetensors
from audioldm_tpu_torch.config import LoRAConfig
from audioldm_tpu_torch.data.wavio import read_wav
from audioldm_tpu_torch.lora import export_peft_state_dict, init_lora
from audioldm_tpu_torch.pipeline import generate as pg
from test_torch_port_pipeline import SECONDS, checkpoint, jax_modules  # noqa: F401 (fixtures)
from test_torch_port_train_cli import RUN, _yaml, corpus  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def torchrun(*args, nproc: int = 2) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(nproc),
           "-m", "audioldm_tpu_torch.cli", *args]
    try:
        run = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=TIMEOUT_S, cwd=REPO)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"{' '.join(args[:1])} under torchrun did not finish within {TIMEOUT_S} s") from e
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    return run


def _close(a: dict, b: dict, atol: float) -> None:
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=atol, err_msg=k)


def test_train_dp2_equals_one_process_on_the_global_batch(checkpoint, corpus, tmp_path):  # noqa: F811
    """``train --dp 2`` (2 rows a rank, global batch 4) for 2 steps: the
    saved adapters equal ``train --batch-size 4`` in one process to 1e-6;
    only rank 0 prints and writes."""
    yaml = _yaml(str(tmp_path / "run.yaml"), RUN)
    common = ["--checkpoint", checkpoint, "--config", yaml, "--dataset", corpus, "--max-steps", "2", "--log-every", "1",
              "--validate-every", "0", "--device", "cpu"]
    run = torchrun("train", *common, "--output", str(tmp_path / "dp"), "--dp", "2")
    assert run.stdout.count("done at step 2; final loss") == 1
    cli.main(["train", *common, "--output", str(tmp_path / "one"), "--batch-size", "4"])
    _close(read_safetensors(tmp_path / "dp" / "checkpoint-2" / "model.safetensors"),
           read_safetensors(tmp_path / "one" / "checkpoint-2" / "model.safetensors"), 1e-6)
    assert sum(1 for _ in open(tmp_path / "dp" / "metrics.jsonl")) == 2


def test_serve_dp2_equals_one_process(checkpoint, tmp_path):  # noqa: F811
    """``serve --dp 2 --requests``: four requests on adapter "a" (a bucket of
    4, 2 rows a rank) and one on the base model (a bucket of 1, whole on
    both ranks): the wavs equal one process's to one 16-bit step."""
    mods = pg.AudioLDMModules.from_checkpoint(checkpoint, device="cpu")
    lora = init_lora(mods.unet, LoRAConfig(), torch.Generator().manual_seed(0))
    with torch.no_grad():
        for b in lora.b.values():
            b.copy_(0.3 * torch.randn(b.shape, generator=torch.Generator().manual_seed(1)))
    write_safetensors(str(tmp_path / "a.safetensors"), export_peft_state_dict(lora))
    reqs = tmp_path / "r.jsonl"
    reqs.write_text("".join(f'{{"prompt": "hip hop music {i}", "adapter": "a"}}\n' for i in range(4))
                    + '{"prompt": "rain", "adapter": null}\n')
    common = ["--checkpoint", checkpoint, "--lora", f"a={tmp_path / 'a.safetensors'}", "--requests", str(reqs),
              "--steps", "2", "--seconds", str(SECONDS), "--fp32", "--device", "cpu", "--max-batch", "4"]
    run = torchrun("serve", *common, "--output", str(tmp_path / "dp"), "--dp", "2")
    assert run.stdout.count("served 5 requests") == 1
    cli.main(["serve", *common, "--output", str(tmp_path / "one")])
    for i in range(5):
        a, _ = read_wav(str(tmp_path / "dp" / f"{i:06d}.wav"))
        b, _ = read_wav(str(tmp_path / "one" / f"{i:06d}.wav"))
        np.testing.assert_allclose(a, b, atol=1.5 / 32767)


def test_generate_tp2_equals_one_process(checkpoint, tmp_path):  # noqa: F811
    """``generate --tp 2`` (the tiny UNet's 2 heads and FF split over 2
    ranks): the wav equals one process's to one 16-bit step; one rank
    writes and says so."""
    common = ["--checkpoint", checkpoint, "--prompt", "hip hop music", "--steps", "2", "--seconds", str(SECONDS),
              "--fp32", "--device", "cpu"]
    run = torchrun("generate", *common, "--output", str(tmp_path / "tp.wav"), "--tp", "2")
    assert run.stdout.count("tensor-parallel over 2 devices") == 1 and run.stdout.count("wrote ") == 1
    cli.main(["generate", *common, "--output", str(tmp_path / "one.wav")])
    a, _ = read_wav(str(tmp_path / "tp.wav"))
    b, _ = read_wav(str(tmp_path / "one.wav"))
    np.testing.assert_allclose(a, b, atol=1.5 / 32767)


def test_distill_dp2_equals_one_process_on_the_global_batch(checkpoint, corpus, tmp_path):  # noqa: F811
    """``distill --dp 2`` for 2 steps at w ~ U[2, 3): the EMA and student
    adapters equal ``distill --batch-size 4`` in one process to 1e-5, a
    hundredth of the run's learning rate 1e-3. The global mean taken as two
    half means rounds differently (about 1e-7 of the gradient), and Adam
    divides each gradient by its own running size: an entry with a small
    gradient under the Huber loss moved 1.02e-6 apart in the first run of
    this test."""
    yaml = _yaml(str(tmp_path / "run.yaml"), RUN)
    common = ["--checkpoint", checkpoint, "--config", yaml, "--dataset", corpus, "--max-steps", "2", "--w", "2.0,3.0",
              "--log-every", "1", "--device", "cpu"]
    run = torchrun("distill", *common, "--output", str(tmp_path / "dp"), "--dp", "2")
    assert run.stdout.count("distilled 2 steps") == 1
    cli.main(["distill", *common, "--output", str(tmp_path / "one"), "--batch-size", "4"])
    for name in ("model", "student"):
        _close(read_safetensors(tmp_path / "dp" / f"{name}.safetensors"), read_safetensors(tmp_path / "one" / f"{name}.safetensors"),
               1e-5)


@pytest.mark.parametrize("command,flag", [("train", "--dp"), ("distill", "--dp"), ("serve", "--dp"), ("generate", "--tp")])
def test_a_size_other_than_the_world_exits_naming_torchrun(monkeypatch, command, flag):
    """``--dp 3``/``--tp 3`` when torchrun started 2 processes (its
    ``WORLD_SIZE``): a message naming the torchrun command, before any
    process group is joined."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    args = {"train": ["--dataset", "unused"], "distill": ["--dataset", "unused", "--output", "unused"],
            "serve": ["--requests", "r.jsonl", "--output", "o"], "generate": ["--prompt", "x"]}[command]
    with pytest.raises(SystemExit, match="needs 3 processes, but 2 are running: launch with python -m "
                                         "torch.distributed.run --nproc-per-node 3"):
        cli.main([command, "--checkpoint", "unused", "--device", "cpu", flag, "3", *args])
