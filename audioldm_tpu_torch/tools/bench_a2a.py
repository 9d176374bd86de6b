"""Audio-to-audio (SDEdit) latency on the GPU: s/clip against strength (the
port's copy of the repo's ``tools/bench_a2a.py``).

    python -m audioldm_tpu_torch.tools.bench_a2a [--strengths 1.0,0.75,0.5] [--iters 5] [--steps 50]

Style transfer runs only the last ``int(steps * strength)`` DDIM steps, so
the denoise cost scales with strength while the text, VAE and vocoder tail
stays: this measures the curve through ``pipeline/audio2audio.py
generate_from_audio`` at the flagship geometry (10.24 s, bf16 UNet and VAE,
CFG 2.5; audioldm-s with random weights from seed 0; a random init mel from
seed 1). A strength's first call is reported apart (``first_s``; the JAX
tool's compile time), then the median of ``--iters`` calls on the host
clock between two synchronisations (the JAX tool: their mean).

``bench`` takes ``device="cpu"`` and modules of any width, so that a test
can drive it.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from audioldm_tpu_torch.pipeline.audio2audio import a2a_start_index, generate_from_audio
from audioldm_tpu_torch.pipeline.generate import AudioLDMModules, latent_shape, random_modules
from audioldm_tpu_torch.tools.benchkit import SECONDS, first_then_median, need_device, prompt_rows, report


def bench(modules: AudioLDMModules | None = None, device: str = "cuda", strengths=(1.0, 0.75, 0.5), steps: int = 50,
          iters: int = 5, seconds: float = SECONDS, tokens: int = 512, dtype=torch.bfloat16) -> dict:
    """s/clip of style transfer at each strength."""
    need_device(device)
    modules = modules or random_modules(seed=0, device=device)
    rows = prompt_rows(1, tokens)
    _, _, h, w = latent_shape(modules, 1, seconds)
    factor = 2 ** (len(modules.vae.cfg.block_out_channels) - 1)
    gen = torch.Generator().manual_seed(1)
    mel_init = torch.randn((1, 1, h * factor, w * factor), generator=gen).to(device)
    out = []
    for s in strengths:
        finite = []

        def run(seed):
            wav = generate_from_audio(modules, mel_init, *rows, seed=seed, audio_length_in_s=seconds, dtype=dtype,
                                      device=device, num_inference_steps=steps, strength=s, guidance_scale=2.5)
            finite.append(bool(torch.isfinite(wav).all()))

        first, med = first_then_median(run, 0, iters, device)
        n_run = steps - a2a_start_index(steps, s)
        out.append({"strength": s, "steps_run": n_run, "s_per_clip": med, "first_s": first, "finite": all(finite)})
        print(f"strength {s:4.2f}: {med:.3f} s/clip  ({n_run} steps; first call {first:.1f}s)", flush=True)
    return report("bench_a2a", device, seconds=seconds, steps=steps, results=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--strengths", default="1.0,0.75,0.5")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_a2a: no CUDA GPU available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    modules = random_modules(seed=0, device=args.device)
    print(f"# init: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    bench(modules, args.device, tuple(float(x) for x in args.strengths.split(",")), args.steps, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
