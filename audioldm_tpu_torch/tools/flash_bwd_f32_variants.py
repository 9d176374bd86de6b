"""Time design variants of the fp32 K4/K5 kernels (``csrc/flash_attention_bwd.cu``)
against the shipped ones, on one NVIDIA GPU.

    python -m audioldm_tpu_torch.tools.flash_bwd_f32_variants [variant ...]

Each variant is a copy of ``csrc/`` with a few lines of the kernels
replaced, built by ``kernels._build`` into its own directory under
``_build/`` and timed in its own process: K4 (``flash_bwd_dkv``) and K5
(``flash_bwd_dq``) at the shapes below, as the profiler's device time of a
call (the mean over 20), after a check against ``flash_bwd_plain`` where the
variant still computes the gradients. One JSON line per variant and shape,
with the card's name and power limit (and, built with
``AUDIOLDM_NVCC_FLAGS="-Xptxas -v"``, ptxas's registers, spills and
warnings of each variant). ``products_only`` takes the exp2 and the dS
arithmetic out of the elementwise step, ``no_transform`` leaves the landed
tiles as they are (no lo or transposed planes), ``no_products`` issues no
product: they compute no gradients, so that the split says whether the
products, the elementwise work, the transform warps or the pipeline set the
floor. ``one_transform_warp`` gives the transform one warp instead of three.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from audioldm_tpu_torch.tools.flash_sm90_variants import device_ms

SHAPES = ((2, 8, 4096, 16), (2, 8, 4016, 16))
SOURCE = "flash_attention_bwd.cu"
_ELEMENTWISE = ("      const float p = ex2(sc[i] - l2);\n      const float ds = p * (dp[i] - dl) * a.scale;\n",
                "      const float p = sc[i] + l2;\n      const float ds = dp[i] + dl;\n")
# S and dP issued in turn
_SDP = ("    for (int hi = 0; hi < 2; ++hi)  // S and dP in turn: two independent accumulator chains\n#pragma unroll\n"
        "      for (int kk = 0; kk < DP / 8; ++kk) {\n        s_products(sc, t, 0, hi, kk);\n"
        "        s_products(dp, t, 1, hi, kk);\n      }\n")
VARIANTS = {
    "shipped": [],
    # P = S + lse2 and dS = dP + delta: no exp2, no dS arithmetic
    "products_only": [_ELEMENTWISE],
    # the transform warps only wait and arrive: the products read the tiles as landed and stale planes
    "no_transform": [("      for (int idx = ttid; idx < 2 * NB; idx += C::NTRANSFORM) {",
                      "      for (int idx = ttid; idx < 0; idx += C::NTRANSFORM) {")],
    # no wgmma: the pipeline, the transform and the elementwise work alone
    "no_products": [(_SDP, ""),
                    ("    wg_fence();\n    if constexpr (C::WIDE) {\n", "    wg_fence();\n    if constexpr (false) {\n"),
                    ("    } else {\n#pragma unroll\n      for (int j = 0; j < T / 8; ++j) {\n        WgmmaTF32<DV>::run(f, al[j]",
                     "    } else if constexpr (false) {\n#pragma unroll\n      for (int j = 0; j < T / 8; ++j) {\n"
                     "        WgmmaTF32<DV>::run(f, al[j]")],
    # one transform warp, not three (320 threads: up to 200 registers a thread)
    "one_transform_warp": [("  static constexpr int NTRANSFORM = 96;", "  static constexpr int NTRANSFORM = 32;")],
}
COMPUTES_GRADIENTS = {"shipped", "one_transform_warp"}


def apply(name: str, text: str) -> str:
    """``text`` (the source) with variant ``name``'s lines replaced, each found once."""
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: the text to replace occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def run_variant(name: str) -> None:
    import torch

    from audioldm_tpu_torch.kernels import _build
    from audioldm_tpu_torch.kernels import flash_attention as fa

    if VARIANTS[name]:
        root = os.path.join(_build.BUILD_DIR, "variants_bwd_f32", name)
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(_build.CSRC, os.path.join(root, "csrc"))
        path = os.path.join(root, "csrc", SOURCE)
        with open(path) as f:
            text = apply(name, f.read())
        with open(path, "w") as f:
            f.write(text)
        _build.CSRC, _build.BUILD_DIR = os.path.join(root, "csrc"), os.path.join(root, "build")
    _build.build_all(("flash_attention_bwd",))
    ptxas = [ln.strip() for ln in _build.logs.get("flash_attention_bwd", "").splitlines()
             if "registers" in ln or "spill" in ln or "warning" in ln.lower() or "Performance" in ln]
    if ptxas:  # with AUDIOLDM_NVCC_FLAGS="-Xptxas -v"
        print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, n, d in SHAPES:
        q, k, v, dout = (torch.randn(b, n, h * d, device="cuda", generator=gen).view(b, n, h, d).transpose(1, 2)
                         for _ in range(4))
        q2 = fa.prescale(q)
        o, lse = fa.flash_fwd_lse_plain(q2, k, v)
        delta = (dout * o).sum(dim=-1).contiguous()
        out = {"variant": name, "shape": [b, h, n, d]}
        if name in COMPUTES_GRADIENTS:
            dk, dv = fa.flash_bwd_dkv(q2, k, v, dout, lse, delta)
            dq = fa.flash_bwd_dq(q2, k, v, dout, lse, delta)
            for key, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), fa.flash_bwd_plain(q2, k, v, o, lse, dout)):
                out[f"{key}_max_abs_err"] = (got.double() - ref.double()).abs().max().item()
        out["k4_device_ms"] = device_ms(torch, lambda: fa.flash_bwd_dkv(q2, k, v, dout, lse, delta))
        out["k5_device_ms"] = device_ms(torch, lambda: fa.flash_bwd_dq(q2, k, v, dout, lse, delta))
        print(json.dumps(out), flush=True)


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_f32_variants: no CUDA GPU available", file=sys.stderr)
        return 1
    if len(argv) == 2 and argv[0] == "--one":
        run_variant(argv[1])
        return 0
    names = argv or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"flash_bwd_f32_variants: variants are {', '.join(VARIANTS)}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip()}), flush=True)
    rc = 0
    for name in names:  # one process a variant: the library of a source is loaded once a process
        try:
            rc = subprocess.run([sys.executable, "-m", "audioldm_tpu_torch.tools.flash_bwd_f32_variants", "--one", name],
                                timeout=600).returncode or rc
        except subprocess.TimeoutExpired:
            print(json.dumps({"variant": name, "error": "did not finish in 600 s"}), flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
