"""Attention micro-bench on the GPU: K1 (the port's ``flash_attention``)
beside PyTorch's fused attention and the plain reference, at the UNet's
attention shapes: level 0 ``[2, 8, 4096, 16]``, level 1 ``[2, 8, 1024, 32]``
and ``[2, 8, 4096, 32]``.

    python -m audioldm_tpu_torch.tools.bench_attn [--iters 50] [--dtype bfloat16]

Prints one line per shape and call, then one JSON line of the results with
the card's name and power limit. Times are CUDA-event means over
back-to-back calls (``timed``); a CPU run computes everything and times
nothing.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

SHAPES = ((2, 8, 4096, 16), (2, 8, 1024, 32), (2, 8, 4096, 32))


def timed(fn, *args, iters: int = 50, warmup: int = 2) -> float | None:
    """Seconds per call of ``fn(*args)``: the mean over ``iters``
    back-to-back calls between two CUDA events, after ``warmup`` calls. On
    CPU tensors the calls run and nothing is timed: returns None."""
    for _ in range(warmup):
        fn(*args)
    if not args[0].is_cuda:
        for _ in range(iters):
            fn(*args)
        return None
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def fmt_ms(t: float | None) -> str:
    return "not measured" if t is None else f"{t * 1e3:.4f} ms"


def sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention over ``[B, H, N, D]``: fp32 logits scaled by
    ``1/sqrt(D)``, softmax, P cast to q's dtype, P V accumulated in fp32,
    the result in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def qkv(rng: np.random.Generator, shape, dtype: torch.dtype, device: str):
    """q, k, v of ``shape``: standard normal draws of ``rng``, in ``dtype``."""
    return [torch.from_numpy(rng.standard_normal(shape)).to(device=device, dtype=dtype) for _ in range(3)]


def card(device: str) -> str:
    """The card's name and power limit, as nvidia-smi gives them, or "cpu"."""
    if device == "cpu":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else torch.cuda.get_device_name(0)


def need_device(device: str) -> None:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this bench needs a CUDA GPU (pass device='cpu' to run its arithmetic without timing)")


def bench(shapes=SHAPES, dtype: torch.dtype = torch.bfloat16, iters: int = 50, device: str = "cuda") -> dict:
    """K1, ``F.scaled_dot_product_attention`` and ``sdpa_reference`` at each
    shape: time and max |d| against the reference."""
    from audioldm_tpu_torch.kernels.flash_attention import flash_attention

    need_device(device)
    rng = np.random.default_rng(0)
    results = []
    for shape in shapes:
        q, k, v = qkv(rng, shape, dtype, device)
        ref = sdpa_reference(q, k, v).float()
        for name, fn in (("sdpa_reference", sdpa_reference), ("flash_attention", flash_attention),
                         ("torch_sdpa", F.scaled_dot_product_attention)):
            err = (fn(q, k, v).float() - ref).abs().max().item()
            t = timed(fn, q, k, v, iters=iters)
            print(f"{shape} {name}: {fmt_ms(t)}, max |d| vs reference {err:.3g}", flush=True)
            results.append({"shape": list(shape), "name": name, "ms": None if t is None else t * 1e3,
                            "max_abs_err_vs_reference": err})
    out = {"section": "bench_attn", "card": card(device), "dtype": str(dtype).removeprefix("torch."), "results": results}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_attn: no CUDA GPU available", file=sys.stderr)
        return 1
    bench(dtype=getattr(torch, args.dtype), iters=args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
