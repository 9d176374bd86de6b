"""Cold start of the generation pipeline on the GPU, by stage (the port's
counterpart of the repo's ``tools/bench_compile.py``, which times XLA's
compile of each stage with the persistent cache pointed at an empty
directory).

    python -m audioldm_tpu_torch.tools.bench_compile [--steps 50] [--width full|tiny] [--device cuda] [--skip-build]

PyTorch compiles nothing ahead of a call; what a fresh process pays before
its first clip is the kernels' build and each stage's first call (CUDA
context, library loads, cuDNN's and cuBLAS's first-use choices, the
allocator's first blocks). So, each in a fresh process:

- ``build``: every CUDA source of ``kernels/_build.py`` built by ``nvcc``
  into an empty directory, all at once as ``build_all`` starts them: each
  source's seconds and the wall (skipped with ``--skip-build`` and where
  there is no GPU);
- one process a stage, the kernels already built in the package's build
  directory: ``text`` (``encode_prompt``, 1 x 512 tokens), ``unet_step``
  (one CFG batch-2 step, bf16), ``denoise`` (``--steps`` DDIM steps with CFG
  2.5), ``vae_decode``, ``vocoder`` and ``generate`` (the whole clip): the
  process's import and model set-up (``init_s``), the stage's first call
  and its second call (``first_s``, ``second_s``).

audioldm-s with random weights from seed 0, a 10.24 s clip (``--width
tiny``: the tools' tiny geometry at 0.08 s, fp32, 16 tokens, for a test). The JAX
tool's ``--only-full`` (split against monolithic programs) and ``--cache``
have no counterpart. Prints a line a stage and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

_T0 = time.perf_counter()

import torch  # noqa: E402

from audioldm_tpu_torch.tools.benchkit import SECONDS, TINY, need_device, prompt_rows, report, sync  # noqa: E402

STAGES = ("text", "unet_step", "denoise", "vae_decode", "vocoder", "generate")
WIDTHS = {"full": (SECONDS, torch.bfloat16, 512), "tiny": (0.08, torch.float32, 16)}  # seconds, dtype, tokens
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _child(args: list, timeout: float) -> dict:
    """Run this module in a fresh process; its last stdout line is JSON."""
    env = dict(os.environ, PYTHONPATH=_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "audioldm_tpu_torch.tools.bench_compile", *args], env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"bench_compile {' '.join(args)} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return {**json.loads(proc.stdout.strip().splitlines()[-1]), "process_s": time.perf_counter() - t0}


def build_into(build_dir: str) -> dict:
    """Every CUDA source built into ``build_dir`` (this process's ``_build``
    pointed there): seconds by source and the wall."""
    from audioldm_tpu_torch.kernels import _build

    _build.BUILD_DIR = build_dir
    t0 = time.perf_counter()
    _build.build_all()
    return {"wall_s": time.perf_counter() - t0, "seconds": dict(_build.seconds)}


def stage(name: str, width: str = "full", device: str = "cuda", steps: int = 50) -> dict:
    """Set up the models and time the first and the second call of one
    stage in this process; ``init_s`` counts from this module's import."""
    from audioldm_tpu_torch.pipeline.generate import (decode_latents, denoise, encode_prompt, encode_stage, generate,
                                                      latent_shape, loop_generator, random_modules, vocode)
    from audioldm_tpu_torch.tools.bench_unet_step import step_inputs

    need_device(device)
    seconds, dtype, tokens = WIDTHS[width]
    modules = random_modules(seed=0, device=device, **(TINY if width == "tiny" else {}))
    modules.to(device, dtype)
    rows = prompt_rows(1, tokens)
    dev = modules.device
    if name == "text":
        fn = lambda: encode_prompt(modules, rows[0], rows[1])
    elif name == "unet_step":
        x, t, lbl = step_inputs(modules, 2, seconds, dtype)
        fn = lambda: modules.unet(x, t, lbl)
    elif name == "denoise":
        lat = torch.zeros(latent_shape(modules, 1, seconds), device=dev)
        fn = lambda: denoise(modules, lat, *encode_stage(modules, *rows), steps, 2.5, dtype, generator=loop_generator(0))
    elif name in ("vae_decode", "vocoder"):
        lat = torch.zeros(latent_shape(modules, 1, seconds), device=dev)
        mel = decode_latents(modules, lat, dtype) if name == "vocoder" else None
        fn = ((lambda: decode_latents(modules, lat, dtype)) if name == "vae_decode"
              else (lambda: vocode(modules, mel, int(seconds * modules.vocoder.cfg.sampling_rate))))
    elif name == "generate":
        fn = lambda: generate(modules, *rows, seed=0, num_inference_steps=steps, audio_length_in_s=seconds, dtype=dtype,
                              device=device)
    else:
        raise ValueError(f"stage {name!r} is not one of {STAGES}")
    sync(device)
    init_s = time.perf_counter() - _T0
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        with torch.inference_mode():
            fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return {"stage": name, "init_s": init_s, "first_s": times[0], "second_s": times[1]}


def bench(width: str = "full", device: str = "cuda", steps: int = 50, build: bool = True, timeout: float = 900,
          stages=STAGES) -> dict:
    """The build into an empty directory (on a GPU, unless ``build`` is
    off), then each of ``stages`` in a fresh process."""
    need_device(device)
    out = {"width": width, "steps": steps}
    if build and torch.device(device).type == "cuda":
        with tempfile.TemporaryDirectory() as d:
            out["build"] = _child(["--build-into", d], timeout)
        print(f"build: {out['build']['wall_s']:.1f}s wall; " +
              ", ".join(f"{k} {v:.1f}s" for k, v in out["build"]["seconds"].items()), flush=True)
    if torch.device(device).type == "cuda":
        from audioldm_tpu_torch.kernels import _build

        _build.build_all()  # the stages' processes find the kernels built
    out["stages"] = {}
    for name in stages:
        r = _child(["--stage", name, "--width", width, "--device", device, "--steps", str(steps)], timeout)
        out["stages"][name] = r
        print(f"{name:12s} init {r['init_s']:6.1f}s  first {r['first_s']:8.3f}s  second {r['second_s']:8.3f}s  "
              f"(process {r['process_s']:.1f}s)", flush=True)
    return report("bench_compile", device, **out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--width", choices=tuple(WIDTHS), default="full")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only when asked)")
    ap.add_argument("--skip-build", action="store_true", help="leave out the build into an empty directory")
    ap.add_argument("--stage", choices=STAGES, help="time one stage in this process (a child's form)")
    ap.add_argument("--build-into", metavar="DIR", help="build every source into DIR in this process (a child's form)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_compile: no CUDA GPU available", file=sys.stderr)
        return 1
    if args.build_into:
        print(json.dumps(build_into(args.build_into)), flush=True)
    elif args.stage:
        print(json.dumps(stage(args.stage, args.width, args.device, args.steps)), flush=True)
    else:
        bench(args.width, args.device, args.steps, not args.skip_build)
    return 0


if __name__ == "__main__":
    sys.exit(main())
