"""A trace of one full-size clip through the generate pipeline on the GPU,
ranked by ``tools/read_trace.py`` (the port's copy of the repo's
``tools/profile_pipeline.py``, which traces with ``jax.profiler`` and ranks
with the XPlane reader).

    python -m audioldm_tpu_torch.tools.profile_pipeline [--out DIR] [--steps 50] [--top 30]

audioldm-s with random weights from seed 0, a 10.24 s clip, DDIM 50, CFG 2.5,
bf16 UNet and VAE: one warm-up clip, then one ``generate`` inside
``utils/profiling.py trace_context`` (host and device), which writes
``DIR/trace.json`` with the program's own spans (``gen.prepare``,
``gen.text``, ``gen.denoise`` and its ``gen.step``s, the UNet's blocks,
``gen.decode``, ``gen.vocode``), which the reader ranks. ``--out``
defaults to ``profile_pipeline`` under the working directory.

``profile`` takes ``device="cpu"`` and modules of any width, so that a test
can drive it (the trace then has no device events).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from audioldm_tpu_torch.pipeline.generate import AudioLDMModules, generate, random_modules
from audioldm_tpu_torch.tools import read_trace
from audioldm_tpu_torch.tools.benchkit import SECONDS, need_device, prompt_rows, sync
from audioldm_tpu_torch.utils.profiling import trace_context


def profile(modules: AudioLDMModules | None = None, device: str = "cuda", out: str = "profile_pipeline",
            steps: int = 50, seconds: float = SECONDS, top: int = 30, tokens: int = 512, dtype=torch.bfloat16) -> dict:
    """Warm up with one ``generate``, trace one more into ``out/trace.json``,
    and return ``read_trace.summarize`` of it with the traced clip's host
    seconds."""
    need_device(device)
    modules = modules or random_modules(seed=0, device=device)
    rows = prompt_rows(1, tokens)
    run = dict(num_inference_steps=steps, audio_length_in_s=seconds, dtype=dtype, device=device)
    t0 = time.perf_counter()
    generate(modules, *rows, seed=0, **run)
    sync(device)
    print(f"# warm-up clip: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    with trace_context(out):
        t0 = time.perf_counter()
        wav = generate(modules, *rows, seed=1, **run)
        sync(device)
        clip_s = time.perf_counter() - t0
    result = read_trace.summarize(out, top)
    return {**result, "clip_s": clip_s, "finite": bool(torch.isfinite(wav).all())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="profile_pipeline")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("profile_pipeline: no CUDA GPU available", file=sys.stderr)
        return 1
    profile(None, args.device, os.path.abspath(args.out), args.steps, top=args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
