"""Device time of one ``cli generate --fp32`` denoise step at full width:
DDIM steps of classifier-free guidance (the UNet at batch 2) with the UNet
in fp32, under torch.profiler, with the fp32 K1's launches a step and its
share of the step's device time.

    python -m audioldm_tpu_torch.tools.fp32_step [--steps N]

Random weights from seed 0 at the audioldm-s-full-v2 widths (``config.py``
defaults), a 10.24 s clip, the JAX tools' 512-token prompt rows. One JSON
line with the card's name and power limit. It needs a GPU. The module's
imports are the pipeline's and the launch counters', so it can time another
checkout's kernels: ``PYTHONPATH=OTHER python path/to/fp32_step.py``.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from audioldm_tpu_torch.kernels import launch_counts, reset_launches
from audioldm_tpu_torch.pipeline import generate as pg
from audioldm_tpu_torch.tools.benchkit import SECONDS, prompt_rows, report

K1 = "flash_fwd_f32"  # the fp32 K1 kernel's function (csrc/flash_attention.cu)


def step_profile(mods, cond, uncond, steps: int = 2) -> dict:
    """``steps`` fp32 CFG denoise steps of a 10.24 s clip: the device ms a
    step (the profiler's kernel rows), the fp32 K1's device ms and share of
    it, its launches a step (the wrapper's counter and the profiler's
    records), the wall ms a step without the profiler and the kernels a
    step, by variant (``k1_launches``: ``[[dtype, shape], launches]`` over
    the steps), and the top kernels. ``cond``, ``uncond``: the text embeddings."""
    from torch.profiler import ProfilerActivity, profile

    lat = pg.init_noise(mods, 1, 1, SECONDS)
    run = lambda: pg.denoise(mods, lat, cond, uncond, steps, 2.5, torch.float32)
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
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    rows = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)]
    total_ms = sum(dev_us(e) for e in rows) / 1e3 / steps
    k1_rows = [e for e in rows if K1 in e.key]
    k1_ms = sum(dev_us(e) for e in k1_rows) / 1e3 / steps
    fp32_k1 = {key: n for key, n in counts.get("flash_fwd", {}).items() if key[0] == "float32"}
    top = sorted(rows, key=dev_us, reverse=True)[:8]
    return {
        "steps": steps, "device_ms_per_step": total_ms if total_ms else "not measured",
        "wall_ms_per_step": wall_ms, "k1_device_ms_per_step": k1_ms, "k1_share": k1_ms / total_ms if total_ms else None,
        "k1_launches_per_step": sum(fp32_k1.values()) / steps, "k1_records_per_step": sum(e.count for e in k1_rows) / steps,
        "k1_launches": [[[dtype, list(shape)], n] for (dtype, shape), n in fp32_k1.items()],
        "kernels_per_step": sum(e.count for e in rows) / steps,
        "top": [[e.key[:60], dev_us(e) / 1e3 / steps, e.count / steps] for e in top],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("fp32_step: no CUDA GPU available", file=sys.stderr)
        return 1
    mods = pg.random_modules(seed=0, device="cuda")
    ids, mask, u_ids, u_mask = prompt_rows(1, 512)
    with torch.no_grad():
        cond, uncond = pg.encode_stage(mods, ids, mask, u_ids, u_mask)
    report("fp32_step", "cuda", **step_profile(mods, cond.float(), uncond.float(), args.steps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
