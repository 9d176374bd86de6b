"""Diagnostic variants of the flash kernel, to locate what bounds it on the
GPU: the full kernel against no-exp, no-max and matmul-only loops (K7), the
flash forward with q pre-scaled and its kv tiles in a shallow ring (K8) or
a deep one (K9), and K9 with the row sum from a ones column of V (K10).

    python -m audioldm_tpu_torch.tools.bench_attn_diag [v2|v3|v4|v5]

No argument: every K7 variant at ``[2, 8, 4096, 16]`` bf16, ``exp2`` at
``block_k`` 64, 1024 and N. ``v2``: K8 and K9 against K1. ``v3``: K10.
``v4``: K1, K9 and K10 in turns, twice. ``v5``: K9 against the plain
reference at ``[2, 8, 1024, 32]``, ``[2, 8, 2048, 16]`` and
``[2, 8, 512, 64]``. Each section prints a line per kernel and ends with
one JSON line of its results: time, max |d| against ``sdpa_reference``, the
reference's max |.| and the loop the kernel runs (``"loop"``), with the
card's name and power limit.

The loop: every kernel runs K1's Hopper loop (``"sm90"``: wgmma, a TMA ring
of 64-row K/V tiles, 128 q rows a CTA; K9 64 when its 128-row grid is under
one wave). K8 is K9 in a ring of 2 stages, one kv tile in flight while one
is computed (K9: 4 stages, 3 at d = 128), so v2's K8 against K9 reads what
the deeper ring buys; K10 is K9 with the row sum from a ones block under the
running max, so v3 and v4 read what that buys. The kernels run their own
tiles whatever the block sizes; the block sizes are checked (they must
divide N) and K7 ``exp2`` commits its max once per ``block_k`` rows, so it
also runs at ``block_k = N``, where it is exact.

The section functions take ``device="cpu"`` (and small shapes) to run their
arithmetic through the plain versions without timing anything.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

import numpy as np
import torch

from audioldm_tpu_torch.kernels import attn_diag
from audioldm_tpu_torch.tools.bench_attn import card, fmt_ms, need_device, qkv, sdpa_reference, timed

SHAPE = (2, 8, 4096, 16)  # the UNet's level-0 self-attention of a 10.24 s clip
V5_SHAPES = ((2, 8, 1024, 32), (2, 8, 2048, 16), (2, 8, 512, 64))
TILE = 64  # the CUDA kernels' kv tile


def run(q, k, v, variant: str, block_q: int, block_k: int):
    """K7, one variant of the kv loop over ``[B, H, N, D]``."""
    return attn_diag.diag_loop(q, k, v, variant, block_k, block_q=block_q)


def run_fori_exp2(q, k, v, block_q: int, block_k: int):
    """K8: q pre-scaled by log2(e)/sqrt(d), exp2, a 2-stage kv ring."""
    return attn_diag.fori_exp2(q, k, v, block_q, block_k)


def run_grid3(q, k, v, block_q: int, block_k: int):
    """K9: K8's function with the kv tiles pipelined."""
    return attn_diag.grid3(q, k, v, block_q, block_k)


def run_grid3b(q, k, v, block_q: int, block_k: int, vmem_mb: int = 0):
    """K10: K9 with the row sum from a ones column of V. ``vmem_mb`` is the
    TPU's VMEM limit; it has no meaning on the GPU and is accepted for the
    tool's signature only."""
    return attn_diag.grid3b(q, k, v, block_q, block_k)


def _inputs(device: str, shape):
    """Seeded q, k, v of ``shape`` in bf16 and the fp32 reference output."""
    need_device(device)
    q, k, v = qkv(np.random.default_rng(0), shape, torch.bfloat16, device)
    return q, k, v, sdpa_reference(q, k, v).float()


def _measure(label: str, fn, q, k, v, ref, iters: int, loop: str | None = "sm90") -> dict:
    """One kernel: max |d| against ``ref``, then its time. ``loop``: the loop
    the kernel runs (None for the plain reference)."""
    err = (fn(q, k, v).float() - ref).abs().max().item()
    t = timed(fn, q, k, v, iters=iters)
    print(f"{label}: {fmt_ms(t)}, max |d| vs reference {err:.4g}", flush=True)
    return {"name": label, "ms": None if t is None else t * 1e3, "max_abs_err_vs_reference": err,
            "reference_max_abs": ref.abs().max().item(), "loop": loop}


def _report(section: str, device: str, shape, results: list) -> dict:
    out = {"section": section, "card": card(device), "shape": shape, "dtype": "bfloat16", "results": results}
    print(json.dumps(out), flush=True)
    return out


def exp2_blocks(n: int) -> tuple:
    """K7 exp2's block_k at N kv rows: the kernels' tile, 1024 (the JAX
    tool's) where it is a smaller divisor of N, and N."""
    return tuple(sorted({TILE, n} | ({1024} if TILE < 1024 < n and n % 1024 == 0 else set())))


def main(iters: int = 30, device: str = "cuda", shape=SHAPE) -> dict:
    """Every K7 variant at the kernels' tile, and exp2 also at block_k 1024
    and N."""
    q, k, v, ref = _inputs(device, shape)
    n = shape[2]
    results = []
    for variant in attn_diag.VARIANTS:
        for bk in exp2_blocks(n) if variant == "exp2" else (TILE,):
            fn = functools.partial(run, variant=variant, block_q=TILE, block_k=bk)
            results.append(_measure(f"{variant} bq={TILE} bk={bk}", fn, q, k, v, ref, iters))
    return _report("v1", device, list(shape), results)


def main2(iters: int = 30, device: str = "cuda", shape=SHAPE) -> dict:
    """K8 and K9 against K1 (the port's ``flash_attention``)."""
    from audioldm_tpu_torch.kernels.flash_attention import flash_attention

    q, k, v, ref = _inputs(device, shape)
    results = [_measure("current flash (K1)", flash_attention, q, k, v, ref, iters)]
    for name, fn in (("fori_exp2", run_fori_exp2), ("grid3", run_grid3)):
        results.append(_measure(f"{name} bq={TILE} bk={TILE}", functools.partial(fn, block_q=TILE, block_k=TILE),
                                q, k, v, ref, iters))
    return _report("v2", device, list(shape), results)


def main3(iters: int = 30, device: str = "cuda", shape=SHAPE) -> dict:
    """K10."""
    q, k, v, ref = _inputs(device, shape)
    fn = functools.partial(run_grid3b, block_q=TILE, block_k=TILE)
    return _report("v3", device, list(shape), [_measure(f"grid3b bq={TILE} bk={TILE}", fn, q, k, v, ref, iters)])


def main4(iters: int = 60, device: str = "cuda", shape=SHAPE) -> dict:
    """K1, K9 and K10 in turns, twice."""
    from audioldm_tpu_torch.kernels.flash_attention import flash_attention

    q, k, v, ref = _inputs(device, shape)
    cands = [
        ("current (K1)", flash_attention),
        (f"grid3 {TILE}/{TILE}", functools.partial(run_grid3, block_q=TILE, block_k=TILE)),
        (f"grid3b {TILE}/{TILE}", functools.partial(run_grid3b, block_q=TILE, block_k=TILE)),
    ]
    results = [_measure(f"rep{rep} {name}", fn, q, k, v, ref, iters) for rep in range(2) for name, fn in cands]
    return _report("v4", device, list(shape), results)


def main5(iters: int = 60, device: str = "cuda", shapes=V5_SHAPES) -> dict:
    """K9 against the plain reference at the other attention shapes."""
    need_device(device)
    rng = np.random.default_rng(0)
    results = []
    for shape in shapes:
        q, k, v = qkv(rng, shape, torch.bfloat16, device)
        ref = sdpa_reference(q, k, v).float()
        for r in (_measure(f"{shape} reference", sdpa_reference, q, k, v, ref, iters, None),
                  _measure(f"{shape} grid3 {TILE}/{TILE}", functools.partial(run_grid3, block_q=TILE, block_k=TILE),
                           q, k, v, ref, iters)):
            results.append({"shape": list(shape), **r})
    return _report("v5", device, None, results)


SECTIONS = {"v1": main, "v2": main2, "v3": main3, "v4": main4, "v5": main5}


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("section", nargs="?", default="v1", choices=tuple(SECTIONS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_attn_diag: no CUDA GPU available", file=sys.stderr)
        return 1
    SECTIONS[args.section]()
    return 0


if __name__ == "__main__":
    sys.exit(cli())
