"""Long-form generation on the GPU: full-length attention against
MultiDiffusion windows (the port's copy of the repo's
``tools/bench_longform.py``).

    python -m audioldm_tpu_torch.tools.bench_longform [--seconds 30] [--steps 50] [--window-seconds 10.24] \\
        [--overlap 0.5] [--iters 3] [--modes full,windowed] [--scheduler ddim|dpm++|lcm]

Level-0 attention is quadratic in latent frames: a 30 s clip runs 12 000
tokens a level-0 call against 4096 at 10.24 s. Windowed denoising
(``generate(window_seconds=...)``) stacks overlapping windows into one
batched UNet call a step and averages the overlaps, linear in the clip's
length with every window at the 10.24 s shape. audioldm-s with random
weights from seed 0, bf16 UNet and VAE, CFG 2.5 (lcm: none). A mode's first
call is reported apart (``first_s``), then the median of ``--iters`` calls
on the host clock between two synchronisations (the JAX tool: their mean),
with s per audio-second.

``bench`` takes ``device="cpu"`` and modules of any width, so that a test
can drive it.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from audioldm_tpu_torch.pipeline.generate import AudioLDMModules, generate, random_modules
from audioldm_tpu_torch.tools.benchkit import SECONDS, first_then_median, need_device, prompt_rows, report


def bench(modules: AudioLDMModules | None = None, device: str = "cuda", seconds: float = 30.0, steps: int = 50,
          window_seconds: float = SECONDS, overlap: float = 0.5, iters: int = 3, modes=("full", "windowed"),
          scheduler: str = "ddim", tokens: int = 512, dtype=torch.bfloat16) -> dict:
    """s/clip of each mode: ``full`` (one pass over the whole clip) and
    ``windowed`` (MultiDiffusion windows of ``window_seconds``)."""
    need_device(device)
    modules = modules or random_modules(seed=0, device=device)
    rows = prompt_rows(1, tokens)
    guidance = 1.0 if scheduler == "lcm" else 2.5
    out = []
    for mode in modes:
        ws = None if mode == "full" else window_seconds
        finite = []

        def run(seed):
            wav = generate(modules, *rows, seed=seed, num_inference_steps=steps, audio_length_in_s=seconds,
                           guidance_scale=guidance, dtype=dtype, device=device, scheduler=scheduler,
                           window_seconds=ws, window_overlap=overlap)
            finite.append(bool(torch.isfinite(wav).all()))

        first, med = first_then_median(run, 0, iters, device)
        out.append({"mode": mode, "window_seconds": ws, "overlap": overlap if ws else None, "s_per_clip": med,
                    "s_per_audio_second": med / seconds, "first_s": first, "finite": all(finite)})
        print(f"{mode:9s} {scheduler} seconds={seconds} steps={steps} window={ws} overlap={overlap if ws else '-'}: "
              f"{med:.3f} s/clip ({med / seconds:.4f} s per audio-second)", flush=True)
    return report("bench_longform", device, seconds=seconds, steps=steps, scheduler=scheduler, results=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--window-seconds", type=float, default=SECONDS)
    ap.add_argument("--overlap", type=float, default=0.5)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--modes", default="full,windowed")
    ap.add_argument("--scheduler", default="ddim", choices=["ddim", "dpm++", "lcm"])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_longform: no CUDA GPU available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    modules = random_modules(seed=0, device=args.device)
    print(f"# init: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    bench(modules, args.device, args.seconds, args.steps, args.window_seconds, args.overlap, args.iters,
          tuple(args.modes.split(",")), args.scheduler)
    return 0


if __name__ == "__main__":
    sys.exit(main())
