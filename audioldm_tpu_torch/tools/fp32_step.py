"""Device time of one ``cli generate --fp32`` denoise step at full width:
DDIM steps of classifier-free guidance (the UNet at batch 2) with the UNet
in fp32, under torch.profiler, with the fp32 K1's launches a step and its
share of the step's device time; with ``--one-pass``, the same step with
the one-pass flag on and the fp32 K6's launches and share (at ``--seconds
5.12`` or less the level-0 kv axis is one block, 2048 tokens, and K6
takes every call); with ``--train``, of one fp32 LoRA training step
instead (``Trainer`` in fp32 at batch 2), with the launches a step of the
fp32 K3, K4 and K5 and the device time and share of K4 and K5.

    python -m audioldm_tpu_torch.tools.fp32_step [--steps N] [--seconds S] [--one-pass] [--train]

Random weights from seed 0 at the audioldm-s-full-v2 widths (``config.py``
defaults), a 10.24 s clip (``--seconds``), the JAX tools' 512-token prompt rows (training:
``bench_train_step``'s batch of log-mels of ones). One JSON line with the
card's name and power limit. It needs a GPU. The module's imports are the
pipeline's, the trainer's and the launch counters', so it can time another
checkout's kernels: ``PYTHONPATH=OTHER python path/to/fp32_step.py``.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import torch

from audioldm_tpu_torch.kernels import flash_attention as fa
from audioldm_tpu_torch.kernels import launch_counts, reset_launches
from audioldm_tpu_torch.pipeline import generate as pg
from audioldm_tpu_torch.tools.benchkit import SECONDS, prompt_rows, report

K1 = "flash_fwd_f32"  # the fp32 forward loop's function (csrc/flash_fwd_f32.cuh): K1, K3 and K6 are instances
# the fp32 K6's: the loop's (the only fp32 forward of a one-pass step), or an older checkout's SIMT kernel
K6 = (K1, "flash_one_f32")
# the fp32 K4 and K5 kernels' functions (csrc/flash_attention_bwd.cu)
K4, K5 = "flash_bwd_dkv_f32", "flash_bwd_dq_f32"


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def _profiled(run, steps: int):
    """``run`` (``steps`` steps) once to warm up, once on the host clock and
    once under torch.profiler with the launch counters reset before it:
    ``(rows, wall_ms, counts, fields)``, the profiler's kernel rows (not
    the optimizer's range), the wall ms a step, the counters and the fields
    every profile reports (device ms, wall ms and kernels a step, the top
    kernels)."""
    from torch.profiler import ProfilerActivity, profile

    run()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    counts = launch_counts()
    rows = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer.")]
    total_ms = sum(_dev_us(e) for e in rows) / 1e3 / steps
    top = sorted(rows, key=_dev_us, reverse=True)[:8]
    return rows, total_ms, counts, {
        "steps": steps, "device_ms_per_step": total_ms if total_ms else "not measured", "wall_ms_per_step": wall_ms,
        "kernels_per_step": sum(e.count for e in rows) / steps,
        "top": [[e.key[:60], _dev_us(e) / 1e3 / steps, e.count / steps] for e in top],
    }


def _kernel(rows, fn, total_ms: float, steps: int) -> tuple:
    """The profiler's records a step of kernel function ``fn`` (a name, or
    a tuple of names), its device ms a step and its share of the step."""
    names = (fn,) if isinstance(fn, str) else fn
    mine = [e for e in rows if any(n in e.key for n in names)]
    ms = sum(_dev_us(e) for e in mine) / 1e3 / steps
    return sum(e.count for e in mine) / steps, ms, (ms / total_ms if total_ms else None)


def step_profile(mods, cond, uncond, steps: int = 2, seconds: float = SECONDS, one_pass: bool = False) -> dict:
    """``steps`` fp32 CFG denoise steps of a clip of ``seconds``: the device
    ms a step (the profiler's kernel rows), the fp32 K1's device ms and
    share of it, its launches a step (the wrapper's counter and the
    profiler's records), the wall ms a step without the profiler and the
    kernels a step, by variant (``k1_launches``: ``[[dtype, shape],
    launches]`` over the steps), and the top kernels; with ``one_pass``
    the one-pass flag is on and the same fields, ``k6_...``, are the fp32
    K6's (``k1_launches_per_step`` then counts the K1 calls left). ``cond``,
    ``uncond``: the text embeddings."""
    lat = pg.init_noise(mods, 1, 1, seconds)
    fa.set_one_pass(one_pass)
    try:
        rows, total_ms, counts, out = _profiled(lambda: pg.denoise(mods, lat, cond, uncond, steps, 2.5, torch.float32),
                                                steps)
    finally:
        fa.set_one_pass(False)
    label, name, fn = ("k6", "flash_fwd_one", K6) if one_pass else ("k1", "flash_fwd", K1)
    records, ms, share = _kernel(rows, fn, total_ms, steps)
    fp32 = {name: {key: n for key, n in counts.get(name, {}).items() if key[0] == "float32"}
            for name in ("flash_fwd", "flash_fwd_one")}
    return {**out, "seconds": seconds, "one_pass": one_pass, f"{label}_device_ms_per_step": ms, f"{label}_share": share,
            f"{label}_launches_per_step": sum(fp32[name].values()) / steps, f"{label}_records_per_step": records,
            f"{label}_launches": [[[dtype, list(shape)], n] for (dtype, shape), n in fp32[name].items()],
            "k1_launches_per_step": sum(fp32["flash_fwd"].values()) / steps}


def train_profile(mods, steps: int = 2, batch: int = 2) -> dict:
    """``steps`` fp32 LoRA training steps (``Trainer.step_fn`` in fp32 on
    ``mods``, rank-2 adapters, AdamW; ``bench_train_step``'s batch of
    ``batch`` log-mels of ones and 512 caption ids) after a warm-up step: the
    device ms a step (the profiler's kernel rows), the launches a step of the
    fp32 K3, K4 and K5 (every fp32 variant) by the wrappers' counters and by
    the profiler's records, their device ms a step and share of it, the wall
    ms a step without the profiler, the kernels a step and the top kernels.
    ``launches``: every kernel's counts over the profiled steps, ``{name:
    [[[dtype, shape], n], ...]}``."""
    from audioldm_tpu_torch.config import LoRAConfig, TrainConfig
    from audioldm_tpu_torch.lora import init_lora
    from audioldm_tpu_torch.tools.bench_train_step import make_batch
    from audioldm_tpu_torch.train import Trainer

    lcfg = LoRAConfig()
    data = make_batch(batch, 512)
    with tempfile.TemporaryDirectory() as out_dir:
        trainer = Trainer(mods, lcfg, TrainConfig(), out_dir, dtype=torch.float32)
        state = trainer.init_state(init_lora(mods.unet, lcfg, torch.Generator().manual_seed(0)))
        gen = torch.Generator(device="cuda").manual_seed(0)

        def run():
            nonlocal state
            for _ in range(steps):
                state, _ = trainer.step_fn(state, data, gen)

        rows, total_ms, counts, out = _profiled(run, steps)
    out["batch"] = batch
    for label, name, fn in (("k3", "flash_fwd_lse", K1), ("k4", "flash_bwd_dkv", K4), ("k5", "flash_bwd_dq", K5)):
        records, ms, share = _kernel(rows, fn, total_ms, steps)
        launched = sum(n for (dtype, _), n in counts.get(name, {}).items() if dtype == "float32")
        out.update({f"{label}_launches_per_step": launched / steps,
                    f"{label}_records_per_step": records, f"{label}_device_ms_per_step": ms, f"{label}_share": share})
    out["launches"] = {name: [[[dtype, list(shape)], n] for (dtype, shape), n in c.items()] for name, c in counts.items() if c}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--seconds", type=float, default=SECONDS, help="the clip's length (denoise step)")
    p.add_argument("--one-pass", action="store_true", help="the one-pass flag on: the fp32 K6 where the kv axis is one block")
    p.add_argument("--train", action="store_true", help="an fp32 LoRA training step instead of a denoise step")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("fp32_step: no CUDA GPU available", file=sys.stderr)
        return 1
    mods = pg.random_modules(seed=0, device="cuda")
    if args.train:
        report("fp32_train_step", "cuda", **train_profile(mods, args.steps))
        return 0
    ids, mask, u_ids, u_mask = prompt_rows(1, 512)
    with torch.no_grad():
        cond, uncond = pg.encode_stage(mods, ids, mask, u_ids, u_mask)
    report("fp32_step", "cuda", **step_profile(mods, cond.float(), uncond.float(), args.steps, args.seconds, args.one_pass))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
