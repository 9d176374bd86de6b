"""Performance regression gate on the GPU (the port's copy of the repo's
``tools/check_perf.py``): runs the load-bearing benches and compares them
with the card's own thresholds in ``perf_thresholds.json`` beside this file.
Exits nonzero on any regression.

    python -m audioldm_tpu_torch.tools.check_perf [--skip-pipeline] [--skip-train] [--serving] [--thresholds FILE]

Gates, audioldm-s at full width with random weights from seed 0:

- ``unet_step_ms`` and ``unet_step_device_ms``: one CFG batch-2 UNet step in
  bf16 (``bench_unet_step``'s inputs, the routing as it stands), the host
  clock's median and the profiler's kernel time of one step;
- ``pipeline_s_per_clip``: ``generate`` of a 10.24 s clip, DDIM 50, CFG 2.5;
- ``serving_s_per_clip_b4`` (with ``--serving``, as in the JAX tool): a
  ``ServeEngine`` batch of 4 requests of one rank-4 adapter, the merged
  route, bucket 4;
- ``train_step_b2_ms`` and ``train_step_b2_device_ms``: a LoRA train step at
  batch 2 (``bench_train_step``'s), host median and kernel time.

The host clock moves up to 2x between machines with the same card, and the
port is host-bound (a denoise step launches ~2000 kernels), so the host gates
catch gross regressions only; the device-time gates catch a kernel that stops
routing (level-0 attention through ``sdpa_plain`` raised the UNet step's
kernel time from 10.4 to 38.2 ms on an H100 and left its host time where it
was). Each host figure is the median of single calls
between two synchronisations after warm-up calls (``benchkit.median_s``), as
the JAX tool takes the median of 5 walls; the UNet and train steps replace
its slope timing inside one jit. Prints one JSON line ``{"ok", "card",
"results", "failures"}``.

``check`` takes ``device="cpu"`` and modules of any width, so that a test
can drive it (without a GPU the device-time gates are skipped).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from audioldm_tpu_torch.config import LoRAConfig
from audioldm_tpu_torch.pipeline.generate import AudioLDMModules, generate, random_modules
from audioldm_tpu_torch.serve import AdapterBank, ServeEngine
from audioldm_tpu_torch.tools.bench_serving import PROMPT, make_adapters
from audioldm_tpu_torch.tools.bench_train_step import MEL, make_step
from audioldm_tpu_torch.tools.bench_unet_step import step_inputs, time_step
from audioldm_tpu_torch.tools.benchkit import SECONDS, Tok, device_ms_per_call, median_s, need_device, prompt_rows, report

THRESHOLDS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "perf_thresholds.json")


def bench_unet_step(modules: AudioLDMModules, device: str, seconds: float = SECONDS, iters: int = 20) -> dict:
    """The UNet step's host ms and device ms, in bf16."""
    modules.to(device, torch.bfloat16)
    x, t, lbl = step_inputs(modules, 2, seconds, torch.bfloat16)
    r = time_step(modules.unet, x, t, lbl, device, iters=iters)
    with torch.inference_mode():
        dev = device_ms_per_call(lambda: modules.unet(x, t, lbl)) if torch.device(device).type == "cuda" else None
    return {"unet_step_ms": r["ms"], "unet_step_device_ms": dev, "unet_step_k1_launches": r["k1_launches_per_step"]}


def bench_pipeline(modules: AudioLDMModules, device: str, seconds: float = SECONDS, steps: int = 50,
                   timed: int = 5, tokens: int = 512) -> dict:
    rows = prompt_rows(1, tokens)

    def run(seed):
        generate(modules, *rows, seed=seed, num_inference_steps=steps, audio_length_in_s=seconds, guidance_scale=2.5,
                 device=device)

    return {"pipeline_s_per_clip": median_s(run, 2, timed, device)}


def bench_serving(modules: AudioLDMModules, device: str, seconds: float = SECONDS, steps: int = 50,
                  timed: int = 5, tokens: int = 512) -> dict:
    lcfg = LoRAConfig(r=4, lora_alpha=4)
    bank = AdapterBank.from_adapters(make_adapters(modules, lcfg, {"a": 1}), lcfg, device=device)
    eng = ServeEngine(modules, Tok(tokens), lcfg, bank=bank, bucket_sizes=(4,), device=device)
    gen = dict(num_inference_steps=steps, audio_length_in_s=seconds, guidance_scale=2.5)
    s = median_s(lambda seed: eng.generate([PROMPT] * 4, adapters=["a"] * 4, seed=seed, **gen), 2, timed, device)
    return {"serving_s_per_clip_b4": s / 4}


def bench_train(modules: AudioLDMModules, device: str, timed: int = 5, tokens: int = 64, mel=MEL) -> dict:
    run = make_step(modules, 2, tokens, device=device, mel=mel)
    s = median_s(run, 2, timed, device)
    dev = device_ms_per_call(run) if torch.device(device).type == "cuda" else None
    return {"train_step_b2_ms": s * 1e3, "train_step_b2_device_ms": dev}


def load_thresholds(path: str = THRESHOLDS) -> dict:
    with open(path) as f:
        return {k: v for k, v in json.load(f).items() if not k.startswith("_")}


def check(modules: AudioLDMModules | None = None, device: str = "cuda", thresholds: dict | None = None,
          pipeline: bool = True, train: bool = True, serving: bool = False, **sizes) -> dict:
    """Run the gates and compare each figure with its threshold; ``sizes``
    (``seconds``, ``steps``, ``tokens``, ``mel``) shrink the benches for a
    test. The train step runs last: its ``Trainer`` casts the frozen models
    whole to bf16."""
    need_device(device)
    thresholds = load_thresholds() if thresholds is None else thresholds
    modules = modules or random_modules(seed=0, device=device)
    clip = {k: sizes[k] for k in ("seconds", "steps", "tokens") if k in sizes}
    results = bench_unet_step(modules, device, sizes.get("seconds", SECONDS))
    if pipeline:
        results.update(bench_pipeline(modules, device, **clip))
    if serving:
        results.update(bench_serving(modules, device, **clip))
    if train:
        results.update(bench_train(modules, device, **{k: sizes[k] for k in ("tokens", "mel") if k in sizes}))
    failures = [f"{k} {v:.4g} > {thresholds[k]}" for k, v in results.items()
                if k in thresholds and v is not None and v > thresholds[k]]
    return report("check_perf", device, ok=not failures, results=results, failures=failures)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--thresholds", default=THRESHOLDS)
    ap.add_argument("--skip-pipeline", action="store_true", help="skip the 50-step clip")
    ap.add_argument("--skip-train", action="store_true", help="skip the train step")
    ap.add_argument("--serving", action="store_true", help="also gate the batch-4 ServeEngine path")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("check_perf: no CUDA GPU available", file=sys.stderr)
        return 1
    out = check(None, args.device, load_thresholds(args.thresholds), not args.skip_pipeline, not args.skip_train,
                args.serving)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
