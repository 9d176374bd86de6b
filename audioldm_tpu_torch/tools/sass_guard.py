"""Do K1, K6 and K3 compile to the same code as in another checkout?

    python -m audioldm_tpu_torch.tools.sass_guard OTHER_CSRC      (on the GPU machine, for nvcc and cuobjdump)

Builds ``OTHER_CSRC/flash_fwd_sm90.cu`` (for example the ``csrc/`` of the
parent commit, unpacked with ``git archive``) with the same ``nvcc`` command
as ``kernels._build`` into a temporary directory, and this package's
``flash_fwd_sm90.cu``, and compares every ``flash_fwd_sm90_kernel<D, ONE,
LSE>`` instance of the two: its registers a thread and its counts of HGMMA,
UTMALDG, MUFU.EX2, F2FP, LDL and STL (all instructions, ``ALL``, are
reported beside them). One JSON line per instance with both sides, then a
summary line; exits nonzero if an instance is missing or differs.
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


def instances(counts: dict) -> dict:
    """``flash_fwd_sm90_kernel`` instances by their template arguments
    (the mangled names also carry the anonymous namespace's hash)."""
    out = {}
    for name, c in counts.items():
        m = re.search(r"flash_fwd_sm90_kernelILi(\d+)ELb([01])ELb([01])E", name)
        if m:
            out[f"flash_fwd_sm90_kernel<{m.group(1)}, {'true' if m.group(2) == '1' else 'false'}, "
                f"{'true' if m.group(3) == '1' else 'false'}>"] = c
    return out


def main(argv: list[str]) -> int:
    if len(argv) != 1 or not os.path.exists(os.path.join(argv[0], "flash_fwd_sm90.cu")):
        print("usage: python -m audioldm_tpu_torch.tools.sass_guard OTHER_CSRC (a directory holding flash_fwd_sm90.cu)",
              file=sys.stderr)
        return 2
    from audioldm_tpu_torch.kernels import _build

    _build.load("flash_fwd_sm90")
    ours = instances(_build.sass(_build._lib_path(os.path.join(_build.CSRC, "flash_fwd_sm90.cu"))))
    with tempfile.TemporaryDirectory() as tmp:
        csrc = os.path.join(tmp, "csrc")
        shutil.copytree(argv[0], csrc)
        lib = os.path.join(tmp, "libother.so")
        proc = subprocess.run(_build.command(os.path.join(csrc, "flash_fwd_sm90.cu"), lib), capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            print(f"sass_guard: nvcc failed for the other source:\n{proc.stdout}{proc.stderr}", file=sys.stderr)
            return 1
        other = instances(_build.sass(lib))
    differ = []
    for key in sorted(set(ours) | set(other)):
        a, b = other.get(key), ours.get(key)
        same = a is not None and b is not None and all(a[op] == b[op] for op in GATED)
        if not same:
            differ.append(key)
        pick = lambda c: None if c is None else {op: c[op] for op in GATED + ("ALL",)}
        print(json.dumps({"instance": key, "other": pick(a), "this": pick(b), "same": same}), flush=True)
    print(json.dumps({"instances": len(ours), "other_instances": len(other), "differ": differ}), flush=True)
    return 1 if differ or not ours else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
