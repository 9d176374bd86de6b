"""Device time of one ``cli generate --fp32`` denoise step at full width:
DDIM steps of classifier-free guidance (the UNet at batch 2) with the UNet
in fp32, under torch.profiler, with the fp32 K1's launches a step and its
share of the step's device time; with ``--train``, of one fp32 LoRA
training step instead (``Trainer`` in fp32 at batch 2), with the launches
a step of the fp32 K3, K4 and K5 and the device time and share of K4 and K5.

    python -m audioldm_tpu_torch.tools.fp32_step [--steps N] [--train]

Random weights from seed 0 at the audioldm-s-full-v2 widths (``config.py``
defaults), a 10.24 s clip, the JAX tools' 512-token prompt rows (training:
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

from audioldm_tpu_torch.kernels import launch_counts, reset_launches
from audioldm_tpu_torch.pipeline import generate as pg
from audioldm_tpu_torch.tools.benchkit import SECONDS, prompt_rows, report

K1 = "flash_fwd_f32"  # the fp32 K1 kernel's function (csrc/flash_attention.cu); K3 is the same function
# the fp32 K4 and K5 kernels' functions (csrc/flash_attention_bwd.cu)
K4, K5 = "flash_bwd_dkv_f32", "flash_bwd_dq_f32"
TRAIN_VARIANT = ("float32", (2, 8, 4096, 16))  # the level-0 self-attention of a training batch of 2 clips


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


def _kernel(rows, fn: str, total_ms: float, steps: int) -> tuple:
    """The profiler's records a step of kernel function ``fn``, its device
    ms a step and its share of the step."""
    mine = [e for e in rows if fn in e.key]
    ms = sum(_dev_us(e) for e in mine) / 1e3 / steps
    return sum(e.count for e in mine) / steps, ms, (ms / total_ms if total_ms else None)


def step_profile(mods, cond, uncond, steps: int = 2) -> dict:
    """``steps`` fp32 CFG denoise steps of a 10.24 s clip: the device ms a
    step (the profiler's kernel rows), the fp32 K1's device ms and share of
    it, its launches a step (the wrapper's counter and the profiler's
    records), the wall ms a step without the profiler and the kernels a
    step, by variant (``k1_launches``: ``[[dtype, shape], launches]`` over
    the steps), and the top kernels. ``cond``, ``uncond``: the text embeddings."""
    lat = pg.init_noise(mods, 1, 1, SECONDS)
    rows, total_ms, counts, out = _profiled(lambda: pg.denoise(mods, lat, cond, uncond, steps, 2.5, torch.float32), steps)
    records, k1_ms, share = _kernel(rows, K1, total_ms, steps)
    fp32_k1 = {key: n for key, n in counts.get("flash_fwd", {}).items() if key[0] == "float32"}
    return {**out, "k1_device_ms_per_step": k1_ms, "k1_share": share,
            "k1_launches_per_step": sum(fp32_k1.values()) / steps, "k1_records_per_step": records,
            "k1_launches": [[[dtype, list(shape)], n] for (dtype, shape), n in fp32_k1.items()]}


def train_profile(mods, steps: int = 2, batch: int = 2) -> dict:
    """``steps`` fp32 LoRA training steps (``Trainer.step_fn`` in fp32 on
    ``mods``, rank-2 adapters, AdamW; ``bench_train_step``'s batch of
    ``batch`` log-mels of ones and 512 caption ids) after a warm-up step: the
    device ms a step (the profiler's kernel rows), the launches a step of the
    fp32 K3, K4 and K5 at ``TRAIN_VARIANT`` by the wrappers' counters and by
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
        out.update({f"{label}_launches_per_step": counts.get(name, {}).get(TRAIN_VARIANT, 0) / steps,
                    f"{label}_records_per_step": records, f"{label}_device_ms_per_step": ms, f"{label}_share": share})
    out["launches"] = {name: [[[dtype, list(shape)], n] for (dtype, shape), n in c.items()] for name, c in counts.items() if c}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=2)
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
    report("fp32_step", "cuda", **step_profile(mods, cond.float(), uncond.float(), args.steps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
