"""LoRA train-step benchmark at full model size on the GPU (the port's copy
of the repo's ``tools/bench_train_step.py``), through ``train.trainer``.

    python -m audioldm_tpu_torch.tools.bench_train_step [--batch 2] [--tokens 64] [--no-flash] [--remat]
    python -m audioldm_tpu_torch.tools.bench_train_step --sweep     # batch x remat: samples/s, TFLOP/s, MFU
    python -m audioldm_tpu_torch.tools.bench_train_step --distill   # one LCM distill_step instead

A step is ``Trainer.step_fn`` on audioldm-s with random weights from seed 0,
the frozen UNet, VAE and text tower cast to bf16 (``Trainer``'s rule),
rank-2 adapters (alpha 2), AdamW at lr 1e-4, a batch of log-mels of ones
``[B, 1, 1024, 64]`` and ``--tokens`` caption ids. ``--no-flash`` raises
the attention routing threshold above every level's token count, so the
UNet's level-0 attention takes ``sdpa_plain`` and autograd through it
instead of K3-K5. ``--remat`` recomputes the UNet forward in the backward.
``--sweep``: b in 2, 4, 8, 16, 32 without remat and 8, 16, 32 with it; a
batch that runs out of device memory is reported and skipped. MFU is the
step's useful FLOPs (``utils.flops.train_step_flops``) over the time and the
H100 SXM's dense bf16 peak. ``--distill``: one ``train.distill.distill_step``
(student forward and backward, the CFG teacher, the EMA target) at w = 2.5,
the UNet and the VAE cast whole to bf16 as ``cli distill`` casts them.

The JAX tool times N steps inside one jit by the slope between two loop
lengths; here each step is timed on the host clock between two
synchronisations after warm-up steps, and the median is reported
(``benchkit.median_s``). The JAX tool's ``--bwd-bk`` (the TPU backward's kv
block) has no counterpart: the CUDA backward kernels K4 and K5 run fixed
tiles.

The functions take ``device="cpu"`` and modules of any width, so that a test
can drive them.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np
import torch

from audioldm_tpu_torch.config import LoRAConfig, TrainConfig
from audioldm_tpu_torch.lora import init_lora
from audioldm_tpu_torch.pipeline.generate import AudioLDMModules, random_modules
from audioldm_tpu_torch.tools.bench_unet_step import min_tokens
from audioldm_tpu_torch.tools.benchkit import median_s, need_device, report
from audioldm_tpu_torch.train import Trainer
from audioldm_tpu_torch.train.distill import distill_modules, distill_step, init_distill_state
from audioldm_tpu_torch.utils import flops as fl

MEL = (1024, 64)  # log-mel frames and bins of a 10.24 s clip
SWEEP = tuple((b, False) for b in (2, 4, 8, 16, 32)) + tuple((b, True) for b in (8, 16, 32))


def make_batch(b: int, tokens: int, mel=MEL, distill: bool = False) -> dict:
    """The JAX tool's batch: log-mels of ones, ids 5 after a 0, every
    position attended; for distillation also the ``[1, L]`` negative prompt."""
    ids = np.full((b, tokens), 5, np.int32)
    ids[:, 0] = 0
    batch = {"log_mel_spec": np.ones((b, 1) + tuple(mel), np.float32), "input_ids": ids,
             "attention_mask": np.ones((b, tokens), np.int32)}
    if distill:
        u_ids = np.full((1, tokens), 1, np.int32)
        u_ids[:, 0] = 0
        u_mask = np.zeros((1, tokens), np.int32)
        u_mask[:, 0] = 1
        batch.update(uncond_ids=u_ids, uncond_mask=u_mask)
    return batch


def routing(flash: bool):
    """Flash as the model routes it, or no call through K1/K3-K5."""
    return contextlib.nullcontext() if flash else min_tokens(1 << 30)


def step_flops(modules: AudioLDMModules, b: int, tokens: int, remat: bool, mel=MEL) -> float:
    return fl.train_step_flops(modules.unet.cfg, modules.vae.cfg, modules.text_encoder.cfg, batch=b, mel_t=mel[0],
                               mel_f=mel[1], seqlen=tokens, remat=remat)["total"].useful


def make_step(modules: AudioLDMModules, b: int = 2, tokens: int = 64, remat: bool = False, device: str = "cuda",
              dtype=torch.bfloat16, mel=MEL):
    """One train step's closure ``run(i)`` on a fresh ``Trainer`` (rank-2
    adapters, AdamW at lr 1e-4) and the JAX tool's batch; each call appends
    its loss (a device tensor) to ``run.losses``."""
    need_device(device)
    lcfg = LoRAConfig(r=2, lora_alpha=2)
    trainer = Trainer(modules, lcfg, TrainConfig(learning_rate=1e-4), output_dir="", dtype=dtype, remat=remat,
                      device=device)
    state = [trainer.init_state(init_lora(modules.unet, lcfg, torch.Generator().manual_seed(1)))]
    batch = {k: torch.as_tensor(v).to(trainer.device) for k, v in make_batch(b, tokens, mel).items()}
    gen = torch.Generator(device=trainer.device).manual_seed(0)

    def run(_=None):
        state[0], m = trainer.step_fn(state[0], batch, gen)
        run.losses.append(m["loss"])

    run.losses = []
    return run


def bench_one(modules: AudioLDMModules, b: int = 2, tokens: int = 64, remat: bool = False, flash: bool = True,
              device: str = "cuda", warm: int = 2, timed: int = 5, dtype=torch.bfloat16, mel=MEL) -> dict:
    """Median seconds of one train step at batch ``b``, with samples/s,
    TFLOP/s and MFU, and the last loss."""
    run = make_step(modules, b, tokens, remat, device, dtype, mel)
    with routing(flash):
        s = median_s(run, warm, timed, device)
    flops = step_flops(modules, b, tokens, remat, mel)
    return {"batch": b, "remat": remat, "flash": flash, "s": s, "samples_per_s": b / s, "tflops": flops / s / 1e12,
            "mfu": fl.mfu(flops, s), "loss": float(run.losses[-1])}


def _line(r: dict) -> str:
    return (f"train step b={r['batch']:2d} remat={int(r['remat'])}: {r['s'] * 1e3:7.1f} ms  {r['samples_per_s']:7.1f} "
            f"samples/s  {r['tflops']:5.1f} TFLOP/s ({100 * r['mfu']:.1f}% MFU)")


def sweep(modules: AudioLDMModules, tokens: int = 64, flash: bool = True, device: str = "cuda", cases=SWEEP,
          **kw) -> list:
    """``bench_one`` at each (batch, remat) of ``cases``; a case that runs
    out of device memory is printed as FAILED and left out."""
    out = []
    for b, remat in cases:
        try:
            r = bench_one(modules, b, tokens, remat, flash, device, **kw)
        except torch.cuda.OutOfMemoryError as e:
            print(f"train step b={b} remat={int(remat)}: FAILED ({type(e).__name__})", flush=True)
            torch.cuda.empty_cache()
            continue
        print(_line(r), flush=True)
        out.append(r)
    return out


def bench_distill(modules: AudioLDMModules, b: int = 2, tokens: int = 64, flash: bool = True, device: str = "cuda",
                  warm: int = 2, timed: int = 5, dtype=torch.bfloat16, mel=MEL) -> dict:
    """Median seconds of one ``distill_step`` at batch ``b``, w = 2.5."""
    need_device(device)
    modules.to(device)
    distill_modules(modules, dtype)
    lcfg = LoRAConfig(r=2, lora_alpha=2)
    lora = init_lora(modules.unet, lcfg, torch.Generator().manual_seed(1))
    state = [init_distill_state(lora, TrainConfig(learning_rate=1e-4))]
    batch = {k: torch.as_tensor(v).to(modules.device) for k, v in make_batch(b, tokens, mel, distill=True).items()}
    gen = torch.Generator(device=modules.device).manual_seed(0)
    losses = []

    def run(_):
        state[0], m = distill_step(state[0], modules, batch, lcfg, dtype, w=2.5, generator=gen)
        losses.append(m["loss"])

    with routing(flash):
        s = median_s(run, warm, timed, device)
    return {"batch": b, "s": s, "samples_per_s": b / s, "loss": float(losses[-1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--tokens", type=int, default=64, help="caption bucket length")
    ap.add_argument("--no-flash", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--sweep", action="store_true", help="batch x remat: samples/s, TFLOP/s and MFU")
    ap.add_argument("--distill", action="store_true", help="time one LCM distill_step instead")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_train_step: no CUDA GPU available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    modules = random_modules(seed=0, device=args.device)
    print(f"# init: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    flash = not args.no_flash
    if args.distill:
        r = bench_distill(modules, args.batch, args.tokens, flash, args.device)
        print(f"distill step b={r['batch']}: {r['s'] * 1e3:7.1f} ms  {r['samples_per_s']:7.1f} samples/s", flush=True)
        report("bench_train_step", args.device, distill=r)
    elif args.sweep:
        report("bench_train_step", args.device, sweep=sweep(modules, args.tokens, flash, args.device))
    else:
        r = bench_one(modules, args.batch, args.tokens, args.remat, flash, args.device)
        print(_line(r), flush=True)
        report("bench_train_step", args.device, step=r)
    return 0


if __name__ == "__main__":
    sys.exit(main())
