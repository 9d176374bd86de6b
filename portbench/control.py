"""Readings that a cell's limits are set from, apart from the program's own
runs: the control (the plain reference put in the program's place and
computed a precision below the configuration's) and planted faults, at the
cell's own size, seed by seed.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --kind bf16|fp8 [--fault half_batch]

Prints one JSON line a seed with the numbers the cell compares. The
benchmark's runs never run this; ``portbench/tests`` runs it at tiny widths.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402


def readings(root: str, cell: str, seed: int, kind: str, fault: str | None = None, device: str = "cuda",
             overrides: dict | None = None) -> dict:
    """The numbers ``cell`` compares, with the control (or ``fault``) in the
    program's place: its traffic driver's ``control``."""
    bench = harness.load_json(root, "BENCHMARK.json")
    _, cfg, mix, _ = harness.cell_parts(root, bench, cell)
    cfg.update((overrides or {}).get("config", {}))
    mix.update((overrides or {}).get("traffic", {}))
    traffic = harness.load_module(root, "traffic", mix["driver"])
    return traffic.control(cfg, mix, seed, kind, fault, torch.device(device), bench["run_seconds"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kind", default="fp8", choices=("bf16", "fp8"))
    ap.add_argument("--fault", default=None, choices=("half_batch",))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    for s in args.seeds.split(","):
        t = time.perf_counter()
        out = readings(ROOT, args.workload, int(s), args.kind, args.fault)
        print(json.dumps({"workload": args.workload, "seed": int(s), "kind": args.kind, "fault": args.fault,
                          "seconds": time.perf_counter() - t, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
