"""The vocoder's narrow late-stage convolutions on the GPU, direct against
im2col (the port's copy of the repo's ``tools/bench_conv1d_smallc.py``,
which asked whether XLA's conv1d left the TPU's matrix unit idle at 32 and
64 channels).

    python -m audioldm_tpu_torch.tools.bench_conv1d_smallc [--iters 50] [--device cuda]

At the JAX tool's shapes (T = 163 840 at C = 32 with k = 11, 7, 3; T =
81 920 at C = 64 with k = 11, 7; the dilations of the resblocks), in fp32
(TF32 off, as the port's fp32 references run) and bf16, ``F.conv1d``
(cuDNN) on ``[B, C, T]`` against an explicit im2col product ``[B, T, k C]
@ [k C, C]``; their ms and the max |d| between the two in fp32. K2
(``kernels/mrf_conv.py``) replaced these convolutions on the vocoder's path;
the probe says what the library alone does at its shapes. Each time is the
mean of ``--iters`` back-to-back calls between two CUDA events after warm-up
calls (``bench_attn.timed``), where the JAX tool chains the calls in one
jit. Prints one JSON line a case.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from audioldm_tpu_torch.tools.bench_attn import card, timed
from audioldm_tpu_torch.tools.benchkit import need_device

CASES = ((163840, 32, 11, 5), (163840, 32, 7, 3), (163840, 32, 3, 1), (81920, 64, 11, 5), (81920, 64, 7, 3))


def conv_direct(x: torch.Tensor, w: torch.Tensor, dil: int) -> torch.Tensor:
    """``x [B, C, T]``, ``w [Cout, C, k]``: a same-length dilated conv1d."""
    return F.conv1d(x, w, padding=(w.shape[-1] - 1) * dil // 2, dilation=dil)


def conv_im2col(x: torch.Tensor, w: torch.Tensor, dil: int) -> torch.Tensor:
    """The same conv as one product: ``k`` dilated shifts of the padded
    input stacked into ``[B, T, k C]`` times ``[k C, Cout]``."""
    cout, c, k = w.shape
    pad = (k - 1) * dil // 2
    t = x.shape[-1]
    xp = F.pad(x, (pad, pad))
    patches = torch.cat([xp[:, :, i * dil : i * dil + t] for i in range(k)], dim=1)  # [B, k C, T]
    return torch.matmul(w.permute(0, 2, 1).reshape(cout, k * c), patches)


def bench(cases=CASES, device: str = "cuda", iters: int = 50, dtypes=(torch.float32, torch.bfloat16)) -> list:
    """One record a case and dtype: direct and im2col ms, their ratio, and
    the fp32 max |d| between them."""
    need_device(device)
    rng = np.random.default_rng(0)
    name, out = card(torch.device(device).type), []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dtype in dtypes:
            for t, c, k, dil in cases:
                x = torch.from_numpy(rng.standard_normal((1, c, t))).to(device=device, dtype=dtype)
                w = (torch.from_numpy(rng.standard_normal((c, c, k))) * 0.05).to(device=device, dtype=dtype)
                ms_d, ms_i = (timed(fn, x, w, dil, iters=iters) for fn in (conv_direct, conv_im2col))
                err = (conv_direct(x.float(), w.float(), dil) - conv_im2col(x.float(), w.float(), dil)).abs().max().item()
                rec = {"dtype": str(dtype).removeprefix("torch."), "T": t, "C": c, "k": k, "dil": dil,
                       "direct_ms": None if ms_d is None else ms_d * 1e3, "im2col_ms": None if ms_i is None else ms_i * 1e3,
                       "speedup": None if ms_d is None else ms_d / ms_i, "max_abs_err": err}
                print(json.dumps({"tool": "bench_conv1d_smallc", "card": name, **rec}), flush=True)
                out.append(rec)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_conv1d_smallc: no CUDA GPU available", file=sys.stderr)
        return 1
    bench(device=args.device, iters=args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
