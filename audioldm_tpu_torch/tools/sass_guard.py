"""Do the bf16 kernels (K1, K6, K3, K4, K5, K7-K10) compile to the same code as in another checkout?

    python -m audioldm_tpu_torch.tools.sass_guard OTHER_CSRC      (on the GPU machine, for nvcc and cuobjdump)

Builds ``flash_fwd_sm90.cu`` (K1, K6, K3), ``flash_bwd_sm90.cu`` (K4, K5),
``attn_diag_sm90.cu`` (K7), ``attn_diag_grid3_sm90.cu`` (K9) and
``attn_diag_k8_k10_sm90.cu`` (K8, K10) of ``OTHER_CSRC`` (for example the
``csrc/`` of the parent commit, unpacked with ``git archive``) with the same
``nvcc`` command as ``kernels._build`` into a temporary directory, all at
once, and this package's, and compares every ``flash_fwd_sm90_kernel<D,
ONE, LSE>``, ``flash_bwd_dkv_sm90_kernel<D>``, ``flash_bwd_dq_sm90_kernel<D>``
and ``attn_diag_sm90_kernel<D, Fwd::V, NWG>`` instance of the two: its
registers a thread and its counts of HGMMA, UTMALDG, MUFU.EX2, F2FP, LDL
and STL (all instructions, ``ALL``, are reported beside them). The fp32
sources are not compared. One JSON line per instance with both sides, then
a summary line; exits nonzero if an instance is missing or differs.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

GATED = ("REG", "HGMMA", "UTMALDG", "MUFU.EX2", "F2FP", "LDL", "STL")
# K1/K6/K3, K4/K5, K7, K9, K8/K10
SOURCES = ("flash_fwd_sm90", "flash_bwd_sm90", "attn_diag_sm90", "attn_diag_grid3_sm90", "attn_diag_k8_k10_sm90")
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


def main(argv: list[str]) -> int:
    if len(argv) != 1 or not os.path.exists(os.path.join(argv[0], "flash_fwd_sm90.cu")):
        print("usage: python -m audioldm_tpu_torch.tools.sass_guard OTHER_CSRC (a directory holding flash_fwd_sm90.cu)",
              file=sys.stderr)
        return 2
    from audioldm_tpu_torch.kernels import _build

    names = [n for n in SOURCES if os.path.exists(os.path.join(argv[0], f"{n}.cu"))]
    ours, other = {}, {}
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
            ours.update(instances(_build.sass(_build._lib_path(os.path.join(_build.CSRC, f"{n}.cu")))))
        for n, (proc, log) in procs.items():
            proc.wait(timeout=900)
            log.seek(0)
            text = log.read()
            log.close()
            if proc.returncode != 0:
                print(f"sass_guard: nvcc failed for the other {n}.cu:\n{text}", file=sys.stderr)
                return 1
            other.update(instances(_build.sass(os.path.join(tmp, f"lib{n}.so"))))
    differ = []
    for key in sorted(other):  # every instance of the other build; this one's new instances are not compared
        a, b = other[key], ours.get(key)
        same = b is not None and all(a[op] == b[op] for op in GATED)
        if not same:
            differ.append(key)
        pick = lambda c: None if c is None else {op: c[op] for op in GATED + ("ALL",)}
        print(json.dumps({"instance": key, "other": pick(a), "this": pick(b), "same": same}), flush=True)
    print(json.dumps({"sources": names, "instances": len(ours), "other_instances": len(other), "differ": differ}),
          flush=True)
    return 1 if differ or not other else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
