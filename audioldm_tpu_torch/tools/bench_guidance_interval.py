"""Limited-interval guidance latency on the GPU: s/clip against the
guidance interval (the port's copy of the repo's
``tools/bench_guidance_interval.py``).

    python -m audioldm_tpu_torch.tools.bench_guidance_interval [--intervals full,0.05:0.65,0.1:0.5] \\
        [--iters 5] [--steps 50] [--scheduler ddim|dpm++]

Standard CFG runs the batch-2 UNet on every step; with ``guidance_interval
(lo, hi)`` the steps whose timestep lies outside the interval run the
conditional batch-1 UNet instead (``pipeline/generate.py denoise``). This
measures the curve through ``generate`` at the flagship geometry (10.24 s,
bf16 UNet and VAE, CFG 2.5; audioldm-s with random weights from seed 0).
``cfg_steps`` counts the DDIM timesteps inside the interval, as the JAX tool
does for either scheduler. An interval's first call is reported apart
(``first_s``; the JAX tool's compile time), then the median of ``--iters``
calls on the host clock between two synchronisations (the JAX tool: their
mean).

``bench`` takes ``device="cpu"`` and modules of any width, so that a test
can drive it.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from audioldm_tpu_torch.models.scheduler import inference_timesteps
from audioldm_tpu_torch.pipeline.generate import AudioLDMModules, generate, random_modules
from audioldm_tpu_torch.tools.benchkit import SECONDS, first_then_median, need_device, prompt_rows, report


def parse_interval(spec: str):
    """``"full"`` -> None; ``"lo:hi"`` -> ``(lo, hi)``."""
    return None if spec == "full" else tuple(float(x) for x in spec.split(":"))


def cfg_steps(modules: AudioLDMModules, steps: int, interval) -> int:
    """The DDIM timesteps of ``steps`` that guidance covers."""
    ts = inference_timesteps(modules.ddim_cfg, steps)
    if interval is None:
        return len(ts)
    n = modules.ddim_cfg.num_train_timesteps
    return int(np.sum((ts >= interval[0] * (n - 1)) & (ts <= interval[1] * (n - 1))))


def bench(modules: AudioLDMModules | None = None, device: str = "cuda", intervals=(None, (0.05, 0.65), (0.1, 0.5)),
          steps: int = 50, iters: int = 5, scheduler: str = "ddim", seconds: float = SECONDS, tokens: int = 512,
          dtype=torch.bfloat16) -> dict:
    """s/clip at each guidance interval (None: every step)."""
    need_device(device)
    modules = modules or random_modules(seed=0, device=device)
    rows = prompt_rows(1, tokens)
    out = []
    for gi in intervals:
        finite = []

        def run(seed):
            wav = generate(modules, *rows, seed=seed, num_inference_steps=steps, audio_length_in_s=seconds,
                           guidance_scale=2.5, dtype=dtype, device=device, scheduler=scheduler, guidance_interval=gi)
            finite.append(bool(torch.isfinite(wav).all()))

        first, med = first_then_median(run, 0, iters, device)
        n_cfg = cfg_steps(modules, steps, gi)
        label = "full (every-step CFG)" if gi is None else f"({gi[0]}, {gi[1]})"
        out.append({"interval": None if gi is None else list(gi), "cfg_steps": n_cfg, "steps": steps, "s_per_clip": med,
                    "first_s": first, "finite": all(finite)})
        print(f"interval {label:>22}: {med:.3f} s/clip  ({n_cfg}/{steps} CFG steps; first call {first:.1f}s)", flush=True)
    return report("bench_guidance_interval", device, scheduler=scheduler, seconds=seconds, results=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--intervals", default="full,0.05:0.65,0.1:0.5")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--scheduler", default="ddim", choices=["ddim", "dpm++"])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_guidance_interval: no CUDA GPU available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    modules = random_modules(seed=0, device=args.device)
    print(f"# init: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    bench(modules, args.device, tuple(parse_interval(s) for s in args.intervals.split(",")), args.steps, args.iters,
          args.scheduler)
    return 0


if __name__ == "__main__":
    sys.exit(main())
