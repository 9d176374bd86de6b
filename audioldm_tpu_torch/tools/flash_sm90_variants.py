"""Time design variants of the bf16 K1/K6 kernel (``csrc/flash_fwd_sm90.cu``,
its loop in ``csrc/flash_fwd_sm90.cuh``) against the shipped one, on one
NVIDIA GPU.

    python -m audioldm_tpu_torch.tools.flash_sm90_variants [variant ...]

Each variant is a copy of ``csrc/`` with a few lines of the kernel replaced,
built by ``kernels._build`` into its own directory under ``_build/`` and
timed in its own process: K1 and K6 (``flash_attention`` with the one-pass
flag off and on) at the shapes below, as the profiler's device time of a
call (the mean over 20), after a check against the plain versions where
the variant still computes the function. One JSON line per variant and shape,
with the card's name and power limit. ``sweep1_only`` and ``sweep2_only``
split K6's time between its two sweeps and compute no attention.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

SHAPES = ((2, 8, 4096, 16), (1, 8, 4096, 16), (10, 8, 4096, 16), (2, 8, 2048, 32))
_NLOAD = ("      const int nload = W::TWO || W::BLOCKS ? 2 * ntiles : ntiles;", "      const int nload = ntiles;")
_K6 = "    sweep1(0, 0, ntiles, m);\n    start_pv();\n    stream(ntiles, 0, ntiles, true);\n"
_ISSUE = "      wg_fence();\n      issue_s(sn, dk);\n      wg_commit();\n      issue_pv(pcur, dv);\n      wg_commit();\n"
# name -> [(text of the shipped loop, its replacement)]
VARIANTS = {
    "shipped": [],
    # K6's sweep 1 alone: the producer loads K once, the consumers take the row max and stop
    "sweep1_only": [_NLOAD, (_K6, "    sweep1(0, 0, ntiles, m);\n    if (m[0] == 1234.5f) o[0] = o[1];\n    return;\n")],
    # K6's sweep 2 alone, against a max of -inf
    "sweep2_only": [_NLOAD, (_K6, "    start_pv();\n    stream(0, 0, ntiles, true);\n")],
    # K6's l from a product of its own (m64n8k16 against the ones) at every head dim
    "ones_product": [("constexpr bool ONES_COL = W::ONES && DP <= 64;", "constexpr bool ONES_COL = false;"),
                     ("constexpr bool ONES_MMA = W::ONES && DP > 64;", "constexpr bool ONES_MMA = W::ONES;")],
    # K6's l as the FADD of the rounded P, unpacked from the bf16 pairs (K1's l too, in this variant)
    "rounded_sum": [
        ("constexpr bool ONES_COL = W::ONES && DP <= 64;", "constexpr bool ONES_COL = false;"),
        ("constexpr bool ONES_MMA = W::ONES && DP > 64;", "constexpr bool ONES_MMA = false;"),
        ("    rs[0] += (p[0] + p[1]) + (p[4] + p[5]);\n    rs[1] += (p[2] + p[3]) + (p[6] + p[7]);",
         "    rs[0] += (__uint_as_float(pa[jj][0] << 16) + __uint_as_float(pa[jj][0] & 0xffff0000u))"
         " + (__uint_as_float(pa[jj][2] << 16) + __uint_as_float(pa[jj][2] & 0xffff0000u));\n"
         "    rs[1] += (__uint_as_float(pa[jj][1] << 16) + __uint_as_float(pa[jj][1] & 0xffff0000u))"
         " + (__uint_as_float(pa[jj][3] << 16) + __uint_as_float(pa[jj][3] & 0xffff0000u));"),
        ("  static constexpr bool SUM = !ONES && V != Fwd::MATMUL_ONLY;", "  static constexpr bool SUM = V != Fwd::MATMUL_ONLY;"),
        ("  if (W::ONES) {  // every ones column", "  if (false) {  // every ones column"),
    ],
    # the two consumer warpgroups take turns to issue their products (named barriers 1 and 2)
    "pingpong": [(_ISSUE, '      asm volatile("bar.sync %0, 256;\\n" ::"r"(1 + (warp >> 2)) : "memory");\n' + _ISSUE
                  + '      asm volatile("bar.arrive %0, 256;\\n" ::"r"(2 - (warp >> 2)) : "memory");\n'),
                 ("    int t = 1;\n", '    if (warp >> 2) asm volatile("bar.arrive 1, 256;\\n" ::: "memory");\n    int t = 1;\n')],
}
COMPUTES_ATTENTION = {"shipped", "ones_product", "rounded_sum", "pingpong"}


def device_ms(torch, fn, iters: int = 20) -> float | None:
    """Device time of one call of ``fn`` (one kernel launch): the profiler's
    mean kernel time over ``iters`` calls, after a warm-up call. Unlike
    CUDA events around back-to-back calls it leaves out the host's pace,
    which sets the time of calls shorter than the host's time a call."""
    from torch.profiler import ProfilerActivity, profile

    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_call = sum(dev_us(e) / e.count for e in prof.key_averages() if str(e.device_type).endswith("CUDA") and e.count)
    return per_call / 1e3 if per_call else None


def run_variant(name: str) -> None:
    import torch

    from audioldm_tpu_torch.kernels import _build
    from audioldm_tpu_torch.kernels import flash_attention as fa

    if VARIANTS[name]:
        root = os.path.join(_build.BUILD_DIR, "variants", name)
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(_build.CSRC, os.path.join(root, "csrc"))
        path = os.path.join(root, "csrc", "flash_fwd_sm90.cuh")
        with open(path) as f:
            text = f.read()
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: the text to replace occurs {text.count(old)} times")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        _build.CSRC, _build.BUILD_DIR = os.path.join(root, "csrc"), os.path.join(root, "build")
    _build.build_all(("flash_fwd_sm90",))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, n, d in SHAPES:
        q, k, v = (torch.randn(b, n, h * d, device="cuda", generator=gen).bfloat16().view(b, n, h, d).transpose(1, 2)
                   for _ in range(3))
        out = {"variant": name, "shape": [b, h, n, d]}
        for one in (False, True):
            fa.set_one_pass(one)
            try:
                if name in COMPUTES_ATTENTION:
                    got = fa.flash_attention(q[:2], k[:2], v[:2]).double()
                    ref = (fa.flash_one_plain if one else fa.flash_plain)(q[:2], k[:2], v[:2]).double()
                    out[f"{'k6' if one else 'k1'}_max_abs_err"] = (got - ref).abs().max().item()
                out["k6_device_ms" if one else "k1_device_ms"] = device_ms(torch, lambda: fa.flash_attention(q, k, v))
            finally:
                fa.set_one_pass(False)
        print(json.dumps(out), flush=True)


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_sm90_variants: no CUDA GPU available", file=sys.stderr)
        return 1
    if len(argv) == 2 and argv[0] == "--one":
        run_variant(argv[1])
        return 0
    names = argv or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"flash_sm90_variants: variants are {', '.join(VARIANTS)}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip()}), flush=True)
    rc = 0
    for name in names:  # one process a variant: the library of a source is loaded once a process
        try:
            rc = rc or subprocess.run([sys.executable, "-m", "audioldm_tpu_torch.tools.flash_sm90_variants", "--one", name],
                                      timeout=600).returncode
        except subprocess.TimeoutExpired:
            print(json.dumps({"variant": name, "error": "did not finish in 600 s"}), flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
