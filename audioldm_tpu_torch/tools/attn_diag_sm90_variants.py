"""Time design variants of K7-K10 (``csrc/attn_diag_sm90.cu``,
``csrc/attn_diag_grid3_sm90.cu`` and ``csrc/attn_diag_k8_k10_sm90.cu`` on
the shared forward loop ``csrc/flash_fwd_sm90.cuh``) against the shipped
ones, on one NVIDIA GPU.

    python -m audioldm_tpu_torch.tools.attn_diag_sm90_variants [variant ...]

Each variant is a copy of ``csrc/`` with a few lines replaced, built by
``kernels._build`` into its own directory under ``_build/`` (all variants'
``nvcc`` at once; with ``AUDIOLDM_NVCC_FLAGS="-Xptxas -v"`` each kernel's
registers, spills and ptxas's wgmma serialization warnings are printed) and
timed in its own process: K9 at the main shape and the
tool's v5 shapes, K7 ``exp2`` at ``[2, 8, 4096, 16]`` with ``block_k``
1024 and N, K8 at the main shape and at ``[2, 8, 2048, 128]`` and K10 at
the main shape, as the profiler's device time of a call (the mean of the
kernel's records over 20 calls), after a check against the plain versions
(max |d|). One JSON line per variant and shape, with the card's name and
power limit. ``k8_ring3`` and ``k8_ring_k9`` run K8 in a ring of 3 stages
and of K9's depth (4, 3 at d = 128) instead of 2.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

K9_SHAPES = ((2, 8, 4096, 16), (2, 8, 1024, 32), (2, 8, 2048, 16), (2, 8, 512, 64))
K7_SHAPE = (2, 8, 4096, 16)
K8_SHAPES = ((2, 8, 4096, 16), (2, 8, 2048, 128))
SOURCES = ("attn_diag_sm90", "attn_diag_grid3_sm90", "attn_diag_k8_k10_sm90")
_RING = "  static constexpr int RING = V == Fwd::K8 ? 2 : 0;"
# K7 exp2 a block (block_k > 64) sized for one CTA an SM at every head dim
# (no cap of 96 registers at d <= 32)
_ONE_CTA = ("attn_diag_sm90.cuh", "  return NWG == 2 ? Cfg<DP>::MINB : 2 * Cfg<DP>::MINB;",
            "  return V == Fwd::EXP2_BLOCKS ? 1 : NWG == 2 ? Cfg<DP>::MINB : 2 * Cfg<DP>::MINB;")
# K7 exp2 a block with K6's sweep 1: two S register sets in turn, S of tile
# t+1 issued before the max of tile t is taken
_TWO_S = ("flash_fwd_sm90.cuh", "    if constexpr (W::BLOCKS) {\n      float sa[BN / 2];",
          "    if constexpr (false) {\n      float sa[BN / 2];")
# name -> [(file in csrc/, text of the shipped source, its replacement)]
VARIANTS = {
    "shipped": [],
    # K9 in 128-row tiles (two consumer warpgroups) at every shape
    "k9_128_rows": [("attn_diag_grid3_sm90.cu", "  if (rows == 64) return dispatch<Fwd::K9, 1>(",
                     "  if (false) return dispatch<Fwd::K9, 1>(")],
    # K9 in 64-row tiles (one consumer warpgroup) at every shape
    "k9_64_rows": [("attn_diag_grid3_sm90.cu", "  return dispatch<Fwd::K9, 2>(", "  return dispatch<Fwd::K9, 1>(")],
    "exp2_one_cta": [_ONE_CTA],
    "exp2_two_s_sets": [_TWO_S],
    "exp2_two_s_sets_one_cta": [_TWO_S, _ONE_CTA],
    # K8 in a ring of 3 stages, and of K9's depth (Cfg<DP>::STAGES: 4, 3 at d = 128)
    "k8_ring3": [("flash_fwd_sm90.cuh", _RING, _RING.replace("? 2 :", "? 3 :"))],
    "k8_ring_k9": [("flash_fwd_sm90.cuh", _RING, _RING.replace("? 2 :", "? 0 :"))],
}


def _use(name: str) -> None:
    """Point ``kernels._build`` at a patched copy of ``csrc/`` for variant
    ``name`` (written anew; its library, keyed by content, is kept); the
    shipped one builds from the package's own."""
    from audioldm_tpu_torch.kernels import _build

    if not VARIANTS[name]:
        return
    root = os.path.join(_build.BUILD_DIR, "variants", "attn_diag_sm90", name)
    csrc = os.path.join(root, "csrc")
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    for fname, old, new in VARIANTS[name]:
        path = os.path.join(csrc, fname)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: the text to replace occurs {text.count(old)} times in {fname}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    _build.CSRC, _build.BUILD_DIR = csrc, os.path.join(root, "build")


def device_ms(torch, fn, iters: int = 20) -> float | None:
    """Device time of one call of ``fn`` (one launch of the diag kernel):
    the median of the profiler's sound records of ``attn_diag_sm90_kernel``
    over ``iters`` calls (``tools.devtime.kernel_ms``); None, with what the
    sessions held printed, when none is sound."""
    from audioldm_tpu_torch.tools import devtime

    ms, held = devtime.kernel_ms(fn, "attn_diag_sm90_kernel", iters)
    if ms is None:
        print(json.dumps({"device_ms": None, "held": held}), flush=True)
    return ms


def run_variant(name: str) -> None:
    import torch

    from audioldm_tpu_torch.kernels import _build
    from audioldm_tpu_torch.kernels import attn_diag as ad

    _use(name)
    _build.build_all(SOURCES)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in K9_SHAPES:
        q, k, v = (torch.randn(shape, device="cuda", generator=gen).bfloat16() for _ in range(3))
        got, ref = ad.grid3(q, k, v, 64, 64).double(), ad.flash_exp2_plain(q, k, v, 64).double()
        print(json.dumps({"variant": name, "kernel": "K9", "shape": list(shape), "q_rows_asked": ad.q_rows(*shape, sms),
                          "max_abs_err": (got - ref).abs().max().item(),
                          "device_ms": device_ms(torch, lambda: ad.grid3(q, k, v, 64, 64))}), flush=True)
    q, k, v = (torch.randn(K7_SHAPE, device="cuda", generator=gen).bfloat16() for _ in range(3))
    for bk in (1024, K7_SHAPE[2]):
        got, ref = ad.diag_loop(q, k, v, "exp2", bk).double(), ad.diag_loop_plain(q, k, v, "exp2", bk).double()
        print(json.dumps({"variant": name, "kernel": "K7 exp2", "block_k": bk, "shape": list(K7_SHAPE),
                          "max_abs_err": (got - ref).abs().max().item(),
                          "device_ms": device_ms(torch, lambda: ad.diag_loop(q, k, v, "exp2", bk))}), flush=True)
    for kernel, fn, shapes in (("K8", ad.fori_exp2, K8_SHAPES), ("K10", ad.grid3b, K8_SHAPES[:1])):
        for shape in shapes:
            q, k, v = (torch.randn(shape, device="cuda", generator=gen).bfloat16() for _ in range(3))
            got = fn(q, k, v, 64, 64).double()
            ref = ad.flash_exp2_plain(q, k, v, 64, ones=kernel == "K10").double()
            print(json.dumps({"variant": name, "kernel": kernel, "shape": list(shape),
                              "max_abs_err": (got - ref).abs().max().item(),
                              "device_ms": device_ms(torch, lambda: fn(q, k, v, 64, 64))}), flush=True)


def ptxas_summary(log: str) -> dict:
    """Registers and spill bytes by kernel function from ``-Xptxas -v``
    output, with the wgmma serialization warnings (C75xx) it gave."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {"warnings": []}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            out[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
        m = re.search(r"\((C75\d\d)\).*function '(\S+)'", line)
        if m:
            out.setdefault(m.group(2), {"warnings": []})["warnings"].append(m.group(1))
    return out


def build(names: list[str]) -> None:
    """Every variant's libraries at once: one nvcc each, started together.
    With ``AUDIOLDM_NVCC_FLAGS="-Xptxas -v"`` prints each variant's
    registers, spills and wgmma serialization warnings by kernel."""
    from audioldm_tpu_torch.kernels import _build

    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    started = []
    for name in names:
        _use(name)
        for source in SOURCES:
            src = os.path.join(_build.CSRC, f"{source}.cu")
            started.append((name, src, *_build._start(src)))
        _build.CSRC, _build.BUILD_DIR = csrc, build_dir
    for name, src, lib, proc in started:
        if proc is not None:
            _build._finish(src, lib, proc)
            for fn, info in ptxas_summary(_build.logs[os.path.splitext(os.path.basename(src))[0]]).items():
                print(json.dumps({"variant": name, "function": fn, **info}), flush=True)


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("attn_diag_sm90_variants: no CUDA GPU available", file=sys.stderr)
        return 1
    if len(argv) == 2 and argv[0] == "--one":
        run_variant(argv[1])
        return 0
    names = argv or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"attn_diag_sm90_variants: variants are {', '.join(VARIANTS)}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip()}), flush=True)
    build(names)
    rc = 0
    for name in names:  # one process a variant: the library of a source is loaded once a process
        try:
            rc = rc or subprocess.run([sys.executable, "-m", "audioldm_tpu_torch.tools.attn_diag_sm90_variants", "--one", name],
                                      timeout=600).returncode
        except subprocess.TimeoutExpired:
            print(json.dumps({"variant": name, "error": "did not finish in 600 s"}), flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
