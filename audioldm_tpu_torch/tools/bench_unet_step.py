"""UNet eps-step ablation on the GPU (the port's copy of the repo's
``tools/bench_unet_step.py``): how a CFG batch-2 step at full width splits
between attention and everything else (convolutions, norms, feed-forwards,
projections, layout changes).

    python -m audioldm_tpu_torch.tools.bench_unet_step [--iters 20] [--device cuda]

Runs, in this order, one step of audioldm-s's UNet in bf16 on zero latents of
a 10.24 s clip (``[2, 8, 256, 16]``, t = 981), with random weights from seed 0:

- ``flash_l0``: ``set_min_tokens`` at the level-0 count (4096 tokens), so
  that K1 takes level 0 only, as the JAX rule routes it (on the CPU the
  pipeline's routing; the card's own threshold routes more levels);
- ``flash_l0_l1`` and ``flash_l0_l1_l2``: ``set_min_tokens`` lowered to the
  level-1 and level-2 token counts (1024, 256), which route those levels'
  attention through K1 too;
- ``flash_off``: ``set_min_tokens`` above the level-0 count, so that every
  call takes ``sdpa_plain`` on either device (the JAX tool's
  ``use_flash_attention(False)``);
- ``sdpa_ablated``: ``models/nn.py sdpa`` replaced by ``lambda q, k, v, *a:
  v`` (projections and layout changes kept);

and ``attention_core_ms``, ``flash_l0`` less ``sdpa_ablated``. The routing
thresholds and ``sdpa`` are restored in ``finally``. Each step's output is fed
back as the next step's input, as in the JAX tool. The JAX tool times a loop
of steps inside one jit by the slope between two loop lengths; here each
step is timed alone on the host clock between two synchronisations after
warm-up steps, and the median is reported (``benchkit.median_s``). Each run
also reports K1's launches in one step (0 on CPU tensors, which take the
plain versions).

``ablation`` takes ``device="cpu"`` and modules of any width, so that a test
can drive it.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import torch

from audioldm_tpu_torch.kernels import flash_attention as fa
from audioldm_tpu_torch.models import nn as nn_mod
from audioldm_tpu_torch.pipeline.generate import AudioLDMModules, latent_shape, random_modules
from audioldm_tpu_torch.tools.benchkit import SECONDS, median_s, need_device, report

T_STEP = 981  # the JAX tool's timestep


def step_inputs(modules: AudioLDMModules, batch: int = 2, seconds: float = SECONDS, dtype=torch.bfloat16):
    """The JAX tool's step inputs: zero latents of a ``seconds`` clip, t =
    981, class labels of ones, at the CFG batch 2."""
    dev = modules.device
    x = torch.zeros(latent_shape(modules, batch, seconds), dtype=dtype, device=dev)
    t = torch.full((batch,), T_STEP, dtype=torch.long, device=dev)
    lbl = torch.ones((batch, modules.unet.cfg.projection_class_embeddings_input_dim), dtype=dtype, device=dev)
    return x, t, lbl


@contextlib.contextmanager
def sdpa_ablated():
    """``models/nn.py sdpa`` returns v: attention's core removed, its
    projections kept."""
    saved = nn_mod.sdpa
    nn_mod.sdpa = lambda q, k, v, *a: v
    try:
        yield
    finally:
        nn_mod.sdpa = saved


def k1_launches() -> int:
    return sum(fa.flash_attention.launches.values())


@torch.inference_mode()
def time_step(unet, x, t, lbl, device, warm: int = 3, iters: int = 20) -> dict:
    """Median ms of one step, the output fed back as the next input, and
    K1's launches in one step."""
    state = [x]

    def run(_):
        state[0] = unet(state[0], t, lbl).to(x.dtype)

    before = k1_launches()
    run(0)
    launches = k1_launches() - before
    return {"ms": median_s(run, warm, iters, device) * 1e3, "k1_launches_per_step": launches}


@contextlib.contextmanager
def _ablated(level0_tokens: int):
    with fa.min_tokens(level0_tokens), sdpa_ablated():
        yield


def runs(level0_tokens: int) -> dict:
    """The ablation's runs by name: each a context that sets its routing."""
    return {
        "flash_l0": lambda: fa.min_tokens(level0_tokens),
        "flash_l0_l1": lambda: fa.min_tokens(level0_tokens // 4),
        "flash_l0_l1_l2": lambda: fa.min_tokens(level0_tokens // 16),
        "flash_off": lambda: fa.min_tokens(level0_tokens + 1),
        "sdpa_ablated": lambda: _ablated(level0_tokens),
    }


@torch.inference_mode()
def step_output(unet, x, t, lbl, run: str) -> torch.Tensor:
    """One step's output under the routing of ``runs``' ``run``."""
    with runs(x.shape[2] * x.shape[3])[run]():
        return unet(x, t, lbl)


def ablation(modules: AudioLDMModules | None = None, device: str = "cuda", iters: int = 20, warm: int = 3,
             seconds: float = SECONDS, dtype=torch.bfloat16, only=None) -> dict:
    """Every run of the ablation (or those named in ``only``) on one step
    of ``modules`` (audioldm-s with random weights from seed 0 by default),
    cast to ``dtype``; prints a line a run and one JSON line."""
    need_device(device)
    modules = modules or random_modules(seed=0, device=device)
    modules.to(device, dtype)
    x, t, lbl = step_inputs(modules, 2, seconds, dtype)
    level0 = x.shape[2] * x.shape[3]
    results = {}
    for name, ctx in runs(level0).items():
        if only is not None and name not in only:
            continue
        with ctx():
            results[name] = time_step(modules.unet, x, t, lbl, device, warm, iters)
        print(f"{name}: {results[name]['ms']:.3f} ms a step, K1 {results[name]['k1_launches_per_step']} launches",
              flush=True)
    out = {"shape": list(x.shape), "dtype": str(dtype).removeprefix("torch."), "level0_tokens": level0, "runs": results}
    if "flash_l0" in results and "sdpa_ablated" in results:
        core = results["flash_l0"]["ms"] - results["sdpa_ablated"]["ms"]
        out["attention_core_ms"] = core
        print(f"attention core: {core:.3f} ms of {results['flash_l0']['ms']:.3f} ms", flush=True)
    return report("bench_unet_step", device, **out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_unet_step: no CUDA GPU available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    modules = random_modules(seed=0, device=args.device)
    print(f"# init: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    ablation(modules, args.device, iters=args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
