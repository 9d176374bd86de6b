"""Time design variants of K2 (``csrc/mrf_conv.cu``) against the shipped
kernel, on one NVIDIA GPU.

    python -m audioldm_tpu_torch.tools.mrf_variants [variant ...]

Each variant is a copy of ``csrc/`` with a few lines of the kernel replaced,
built by ``kernels._build`` into its own directory under ``_build/`` and
timed in its own process at the two main-path stages ([1, 64, 81936], and
[1, 32, 163872] with conv_post), random weights from a seed: the profiler's
device time of a call (the mean over 5), and max |kernel - plain| / max
|plain| against ``mrf_stage_plain`` with TF32 off. One JSON line per
variant, with the card's name and power limit. ``tf32_alone`` and
``no_product`` compute no fp32-accurate stage: they split the time.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

_PRODUCTS = ("          WgmmaTF32<CP>::run(acc[i], ah[set][kk], dh, tap > 0 || kc > 0);  // the conv's first product overwrites\n"
             "          WgmmaTF32<CP>::run(acc[i], al[set][kk], dh, 1);\n"
             "          WgmmaTF32<CP>::run(acc[i], ah[set][kk], dl, 1);\n")
# name -> [(text of the shipped source, its replacement[, the source, if not mrf_conv.cu])]
VARIANTS = {
    "shipped": [],
    # the a_hi b_hi product alone (TF32 accuracy)
    "tf32_alone": [(_PRODUCTS, "          WgmmaTF32<CP>::run(acc[i], ah[set][kk], dh, tap > 0 || kc > 0);\n")],
    # no product at all: loads, splits, ring, barriers, epilogues (the result is not a stage)
    "no_product": [(_PRODUCTS, "          acc[i][0] += __uint_as_float(ah[set][kk][0] ^ al[set][kk][1]) + (float)(dh ^ dl);\n")],
    # the activations split by cvt.rna.tf32 twice (hi rounded, lo rounded), as the weights are (the
    # split is sm90.cuh's, which the variant's copy changes for K2's build alone)
    "rna_split": [("  hi = __float_as_uint(x) & 0xffffe000u;\n  lo = __float_as_uint(x - __uint_as_float(hi));",
                   "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(hi) : \"f\"(x));\n"
                   "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(lo) : \"f\"(x - __uint_as_float(hi)));", "sm90.cuh")],
    # up to 192 samples a CTA at CP = 64: three 64 x 64 tiles a warpgroup, whose accumulators spill
    "tt192_at_64": [("  static constexpr int TTMAX = CP == 64 ? 128 : 384;", "  static constexpr int TTMAX = CP == 64 ? 192 : 384;")],
}
HAS_ERROR = {"shipped", "rna_split", "tt192_at_64", "tf32_alone"}  # the variants whose error against the plain version means something
KS, DILS = (3, 7, 11), ((1, 3, 5),) * 3


def device_ms(torch, fn, iters: int = 5) -> float | None:
    """Device time of one call of ``fn`` (one kernel launch): the profiler's
    mean kernel time over ``iters`` calls, after a warm-up call."""
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

    from audioldm_tpu_torch.kernels import _build, mrf_conv
    from audioldm_tpu_torch.models.vocoder import HifiGanResidualBlock
    from audioldm_tpu_torch.pipeline.generate import init_random_

    if VARIANTS[name]:
        root = os.path.join(_build.BUILD_DIR, "variants", f"mrf_{name}")
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(_build.CSRC, os.path.join(root, "csrc"))
        for old, new, *source in VARIANTS[name]:
            path = os.path.join(root, "csrc", source[0] if source else "mrf_conv.cu")
            with open(path) as f:
                text = f.read()
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: the text to replace occurs {text.count(old)} times")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        _build.CSRC, _build.BUILD_DIR = os.path.join(root, "csrc"), os.path.join(root, "build")
    _build.build_all(("mrf_conv",))
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {"variant": name}
    for c, t, with_post in ((64, 81936, False), (32, 163872, True)):
        with torch.device("cuda"):
            blocks = [init_random_(HifiGanResidualBlock(c, k, d), gen) for k, d in zip(KS, DILS)]
            post = init_random_(torch.nn.Conv1d(c, 1, 7, padding=3), gen) if with_post else None
        x = torch.randn(1, c, t, device="cuda", generator=gen)
        run = lambda: mrf_conv.mrf_stage(x, blocks, KS, DILS, 0.1, post)
        with torch.no_grad():
            ref = mrf_conv.mrf_stage_plain(x, blocks, KS, DILS, 0.1, post)
            err = ((run() - ref).abs().max() / ref.abs().max()).item()
            out[f"[1,{c},{t}]"] = {"device_ms": device_ms(torch, run), "max_rel_err": err if name in HAS_ERROR else None}
    print(json.dumps(out), flush=True)


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("mrf_variants: no CUDA GPU available", file=sys.stderr)
        return 1
    if len(argv) == 2 and argv[0] == "--one":
        run_variant(argv[1])
        return 0
    names = argv or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"mrf_variants: variants are {', '.join(VARIANTS)}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip()}), flush=True)
    rc = 0
    for name in names:  # one process a variant: the library of a source is loaded once a process
        try:
            rc = rc or subprocess.run([sys.executable, "-m", "audioldm_tpu_torch.tools.mrf_variants", "--one", name],
                                      timeout=600).returncode
        except subprocess.TimeoutExpired:
            print(json.dumps({"variant": name, "error": "did not finish in 600 s"}), flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
