"""Do the bf16 kernels (K1, K6, K3, K4, K5, K7-K10) compile to the same code as in another checkout?

    python -m audioldm_tpu_torch.tools.sass_guard OTHER_CSRC [--run]      (on the GPU machine, for nvcc and cuobjdump)

Builds ``flash_fwd_sm90.cu`` (K1, K6, K3), ``flash_bwd_sm90.cu`` (K4, K5),
``attn_diag_sm90.cu`` (K7), ``attn_diag_grid3_sm90.cu`` (K9) and
``attn_diag_k8_k10_sm90.cu`` (K8, K10) of ``OTHER_CSRC`` (for example the
``csrc/`` of the parent commit, unpacked with ``git archive``) with the same
``nvcc`` command as ``kernels._build`` into a temporary directory, all at
once, and this package's, and compares every ``flash_fwd_sm90_kernel<D,
ONE, LSE>``, ``flash_bwd_dkv_sm90_kernel<D>``, ``flash_bwd_dq_sm90_kernel<D>``
and ``attn_diag_sm90_kernel<D, Fwd::V, NWG>`` instance of the two: its
registers a thread and its counts of HGMMA, UTMALDG, MUFU.EX2, F2FP, LDL
and STL (all instructions, ``ALL``, are reported beside them); exits
nonzero if one is missing or differs. It also builds both checkouts'
``flash_attention.cu`` (the fp32 K1 and K3, ``flash_fwd_f32``) and
``flash_attention_bwd.cu`` (the fp32 K4 and K5) and reports the same
counts of their instances side by side (``f32_instances``: K1 and K3 by
head dim and variant; the fp32 K6 of ``flash_attention.cu`` has no
counterpart there before the fp32 forward loop took it), not gated. With
``--run`` it then launches both builds' fp32 K1 and K3 on the same inputs
(``RUN_SHAPES``, head views of [B, N, H * D] projections as the UNet hands
them over): equal bits of out and lse2, and device ms of each (CUDA events
over 50 launches, in turns other, this, this, other), one JSON line each
with the card's name and power limit; a difference in bits exits nonzero.
One JSON line per instance with both sides, then a summary line.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile

GATED = ("REG", "HGMMA", "UTMALDG", "MUFU.EX2", "F2FP", "LDL", "STL")
# K1/K6/K3, K4/K5, K7, K9, K8/K10
SOURCES = ("flash_fwd_sm90", "flash_bwd_sm90", "attn_diag_sm90", "attn_diag_grid3_sm90", "attn_diag_k8_k10_sm90")
F32_SOURCES = ("flash_attention", "flash_attention_bwd")  # fp32 K1/K3 (and K6), K4/K5: reported, not gated
# the fp32 K1 and K3 launched by --run: the UNet's level-0 shapes under --fp32 and the other head dims
RUN_SHAPES = ((2, 8, 4096, 16), (2, 8, 4016, 16), (2, 8, 2048, 32), (1, 4, 1000, 64), (1, 2, 777, 128))
# the values of flash_fwd_sm90.cuh's `enum class Fwd`, which the mangled names carry
FWD = ("K1", "K6", "K3", "K9", "FULL", "EXP2", "EXP2_BLOCKS", "NO_MAX", "NO_EXP", "MATMUL_ONLY", "K8", "K10")


def instances(counts: dict) -> dict:
    """``flash_fwd_sm90_kernel``, ``flash_bwd_*_sm90_kernel`` and
    ``attn_diag_sm90_kernel`` instances by their template arguments (the
    mangled names also carry the anonymous namespace's hash)."""
    out = {}
    flag = lambda b: "true" if b == "1" else "false"
    for name, c in counts.items():
        m = re.search(r"flash_fwd_sm90_kernelILi(\d+)ELb([01])ELb([01])E", name)
        if m:
            out[f"flash_fwd_sm90_kernel<{m.group(1)}, {flag(m.group(2))}, {flag(m.group(3))}>"] = c
        m = re.search(r"flash_bwd_(dkv|dq)_sm90_kernelILi(\d+)E", name)
        if m:
            out[f"flash_bwd_{m.group(1)}_sm90_kernel<{m.group(2)}>"] = c
        m = re.search(r"attn_diag_sm90_kernelILi(\d+)EL\w*?3FwdE(\d+)ELi(\d+)E", name)
        if m:
            out[f"attn_diag_sm90_kernel<{m.group(1)}, Fwd::{FWD[int(m.group(2))]}, {m.group(3)}>"] = c
    return out


def f32_instances(counts: dict) -> dict:
    """The fp32 K1 and K3 (``flash_fwd_f32``, a bool LSE or the fp32 loop's
    ``F32`` variant 0 or 1 as template argument) and K4 and K5
    (``flash_bwd_dkv_f32``, ``flash_bwd_dq_f32``) instances by head dim and
    kernel."""
    out = {}
    for name, c in counts.items():
        m = re.search(r"flash_fwd_f32ILi(\d+)EL(?:b|\w*?3F32E)([01])E", name)
        if m:
            out[f"flash_fwd_f32<{m.group(1)}, {('K1', 'K3')[int(m.group(2))]}>"] = c
        m = re.search(r"flash_bwd_(dkv|dq)_f32ILi(\d+)E", name)
        if m:
            out[f"flash_bwd_{m.group(1)}_f32<{m.group(2)}>"] = c
    return out


def run_f32(other_lib: str) -> bool:
    """The fp32 K1 and K3 of this package's build and of ``other_lib`` on the
    same inputs at ``RUN_SHAPES``: equal bits, device ms in turns. True when
    every output is equal."""
    import ctypes

    import torch

    from audioldm_tpu_torch.kernels import _build
    from audioldm_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    libs = {"other": ctypes.CDLL(other_lib), "this": _build.load("flash_attention")}
    fns = {}
    for side, lib in libs.items():
        for name, args in (("flash_fwd", fa._FWD_ARGS), ("flash_fwd_lse", fa._LSE_ARGS)):
            f = getattr(lib, name)
            f.restype, f.argtypes = ctypes.c_int, args
            fns[side, name] = f
    gen = torch.Generator(device="cuda").manual_seed(0)
    same_all = True
    for b, h, n, d in RUN_SHAPES:
        q, k, v = (torch.randn(b, n, h * d, device="cuda", generator=gen).view(b, n, h, d).transpose(1, 2) for _ in range(3))
        q2 = fa.prescale(q)
        out = {side: (fa._heads_buffer(q), fa._heads_buffer(q), torch.empty((b, h, n), device="cuda")) for side in libs}
        stream = torch.cuda.current_stream().cuda_stream

        def launch(side, kernel):
            o1, o3, lse = out[side]
            if kernel == "K1":
                err = fns[side, "flash_fwd"](q.data_ptr(), k.data_ptr(), v.data_ptr(), o1.data_ptr(), b, h, n, n, d,
                                             fa._strides(q, k, v, o1), fa._LOG2E / math.sqrt(d), stream)
            else:
                err = fns[side, "flash_fwd_lse"](q2.data_ptr(), k.data_ptr(), v.data_ptr(), o3.data_ptr(), lse.data_ptr(),
                                                 b, h, n, n, d, fa._strides(q2, k, v, o3), 1.0, stream)
            _build.check(err, f"{side} {kernel}")

        def ms(side, kernel, iters=50):
            launch(side, kernel)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                launch(side, kernel)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / iters

        for kernel in ("K1", "K3"):
            turns = [(side, ms(side, kernel)) for side in ("other", "this", "this", "other")]
            i = 0 if kernel == "K1" else 1
            same = torch.equal(out["other"][i], out["this"][i]) and (kernel == "K1" or torch.equal(out["other"][2], out["this"][2]))
            same_all &= same
            print(json.dumps({"kernel": f"fp32 {kernel}", "shape": [b, h, n, d], "same_bits": same,
                              "ms_turns": [[s, t] for s, t in turns], "card": card}), flush=True)
    return same_all


def main(argv: list[str]) -> int:
    run = "--run" in argv
    argv = [a for a in argv if a != "--run"]
    if len(argv) != 1 or not os.path.exists(os.path.join(argv[0], "flash_fwd_sm90.cu")):
        print("usage: python -m audioldm_tpu_torch.tools.sass_guard OTHER_CSRC [--run] (a directory holding "
              "flash_fwd_sm90.cu)", file=sys.stderr)
        return 2
    from audioldm_tpu_torch.kernels import _build

    names = [n for n in SOURCES + F32_SOURCES if os.path.exists(os.path.join(argv[0], f"{n}.cu"))]
    ours, other, ours_f32, other_f32 = {}, {}, {}, {}
    same_bits = True
    with tempfile.TemporaryDirectory() as tmp:
        csrc = os.path.join(tmp, "csrc")
        shutil.copytree(argv[0], csrc)
        procs = {}
        for n in names:  # the other build's nvcc, all at once and beside this package's (a log file each: no pipe fills)
            log = open(os.path.join(tmp, f"{n}.log"), "w+")
            procs[n] = (subprocess.Popen(_build.command(os.path.join(csrc, f"{n}.cu"), os.path.join(tmp, f"lib{n}.so")),
                                         stdout=log, stderr=subprocess.STDOUT, text=True), log)
        _build.build_all(names)
        for n in names:
            counts = _build.sass(_build._lib_path(os.path.join(_build.CSRC, f"{n}.cu")))
            ours.update(instances(counts))
            ours_f32.update(f32_instances(counts))
        for n, (proc, log) in procs.items():
            proc.wait(timeout=900)
            log.seek(0)
            text = log.read()
            log.close()
            if proc.returncode != 0:
                print(f"sass_guard: nvcc failed for the other {n}.cu:\n{text}", file=sys.stderr)
                return 1
            counts = _build.sass(os.path.join(tmp, f"lib{n}.so"))
            other.update(instances(counts))
            other_f32.update(f32_instances(counts))
        if run and "flash_attention" in names:
            same_bits = run_f32(os.path.join(tmp, "libflash_attention.so"))
    differ = []
    for key in sorted(other):  # every instance of the other build; this one's new instances are not compared
        a, b = other[key], ours.get(key)
        same = b is not None and all(a[op] == b[op] for op in GATED)
        if not same:
            differ.append(key)
        pick = lambda c: None if c is None else {op: c[op] for op in GATED + ("ALL",)}
        print(json.dumps({"instance": key, "other": pick(a), "this": pick(b), "same": same}), flush=True)
    differ_f32 = []
    for key in sorted(other_f32):  # reported beside the gated ones
        a, b = other_f32[key], ours_f32.get(key)
        same = b is not None and all(a[op] == b[op] for op in GATED)
        if not same:
            differ_f32.append(key)
        pick = lambda c: None if c is None else {op: c[op] for op in GATED + ("ALL",)}
        print(json.dumps({"instance": key, "other": pick(a), "this": pick(b), "same": same, "gated": False}), flush=True)
    print(json.dumps({"sources": names, "instances": len(ours), "other_instances": len(other), "differ": differ,
                      "f32_instances": len(ours_f32), "f32_differ": differ_f32, "f32_same_bits": same_bits}), flush=True)
    return 1 if differ or not other or not same_bits else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
