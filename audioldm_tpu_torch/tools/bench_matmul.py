"""Matrix-product rate on the GPU at the flash-attention constituent shapes
against deep ones (the port's copy of the repo's ``tools/bench_matmul.py``,
which probes the TPU's MXU): ``torch.matmul`` in bf16 (fp32 accumulation,
cuBLAS) of ``[m, k] x [k, n]``, its ms and TFLOP/s and the share of the
H100 SXM's dense bf16 peak.

    python -m audioldm_tpu_torch.tools.bench_matmul [--iters 50] [--device cuda]

The shapes are the JAX tool's: a 512-row QK^T block at contraction 128,
all 4096 q rows at once, the PV blocks at 128 output columns, and square
products to 4096. Each time is the mean of ``--iters`` back-to-back calls
between two CUDA events after warm-up calls (``bench_attn.timed``), where
the JAX tool chains the products in one jit. A product no kernel of the
port runs: the probe says what the card's library reaches at these shapes.
Prints a line a shape and one JSON line.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from audioldm_tpu_torch.tools.bench_attn import timed
from audioldm_tpu_torch.tools.benchkit import need_device, report
from audioldm_tpu_torch.utils.flops import H100_SXM_BF16_PEAK

SHAPES = ((512, 128, 1024), (512, 128, 4096), (4096, 128, 4096), (512, 1024, 128), (512, 4096, 128),
          (4096, 4096, 128), (512, 512, 512), (2048, 2048, 2048), (4096, 4096, 4096))


def bench(shapes=SHAPES, device: str = "cuda", iters: int = 50, dtype=torch.bfloat16) -> dict:
    """ms, TFLOP/s and peak share of ``a @ b`` at each ``(m, k, n)``
    (None on the CPU, where nothing is timed)."""
    need_device(device)
    rng = np.random.default_rng(0)
    results = []
    for m, k, n in shapes:
        a, b = (torch.from_numpy(rng.standard_normal(s)).to(device=device, dtype=dtype) for s in ((m, k), (k, n)))
        t = timed(torch.matmul, a, b, iters=iters)
        flops = 2 * m * k * n
        r = {"shape": [m, k, n], "ms": None if t is None else t * 1e3,
             "tflops": None if t is None else flops / t / 1e12,
             "peak_share": None if t is None else flops / t / H100_SXM_BF16_PEAK}
        results.append(r)
        line = "not measured" if t is None else f"{r['ms']:.4f} ms  {r['tflops']:.1f} TFLOP/s ({100 * r['peak_share']:.1f}% of peak)"
        print(f"[{m},{k}]x[{k},{n}]: {line}", flush=True)
    return report("bench_matmul", device, dtype=str(dtype).removeprefix("torch."), results=results)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_matmul: no CUDA GPU available", file=sys.stderr)
        return 1
    bench(device=args.device, iters=args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
