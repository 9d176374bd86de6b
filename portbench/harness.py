"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``portbench/configs/<config>.json``)
and its traffic mix (``portbench/traffic/<traffic>.json``, data that names
its driver, ``portbench/traffic/<driver>.py``); each metric is read by
``portbench/metrics/<metric>.py``; the limits of the cell's comparison are
``portbench/limits/<cell>.json``. A cell, a mix, a driver or a metric is
added by adding files and entries, without editing any file.

The driver builds the program from the seed, warms up the cell's shapes,
measures for ``--seconds``, and checks what the timed path produced against
the plain reference (``portbench/reference``). With ``--trace 0`` the line
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics. The last line of standard output is one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error and
the last key of that object.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "audioldm_tpu")


def load_json(root: str, *parts: str) -> dict:
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def load_module(root: str, kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(root, "portbench", kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_parts(root: str, bench: dict, cell: str) -> tuple[dict, dict, dict, dict]:
    """``(workload entry, configuration, traffic mix, limits)`` of ``cell``."""
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json; have {[w['name'] for w in bench['workloads']]}")
    cfg = load_json(root, "portbench", "configs", f"{entry['config']}.json")
    mix = load_json(root, "portbench", "traffic", f"{entry['traffic']}.json")
    limits = load_json(root, "portbench", "limits", f"{cell}.json")
    return entry, cfg, mix, limits


def metrics_of(bench: dict, cell: str, trace: int) -> list:
    """The metric entries a cell reports: with ``trace`` 0 its end-to-end
    metrics, with 1 its per-layer metrics (listed for it, or, without a
    ``workloads`` key, those whose ``moves`` metric the cell reports)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def run_cell(root: str, cell: str, seed: int, seconds: float, trace: int, device: str = "cuda",
             overrides: dict | None = None, t0: float | None = None) -> dict:
    """Run ``cell`` once; returns the result object (without printing).
    ``overrides`` replaces configuration groups, mix keys or limits (the
    CPU tests' tiny widths) and ``device`` may be ``"cpu"`` there."""
    import torch

    from portbench.compare import verdict

    t0 = time.perf_counter() if t0 is None else t0
    bench = load_json(root, "BENCHMARK.json")
    entry, cfg, mix, limits = cell_parts(root, bench, cell)
    for key, val in (overrides or {}).get("config", {}).items():
        cfg[key] = val
    mix.update((overrides or {}).get("traffic", {}))
    limits.update((overrides or {}).get("limits", {}))
    driver = load_module(root, "traffic", mix["driver"])
    dev = torch.device(device)
    ctx = driver.run(cfg=cfg, mix=mix, seed=seed, seconds=seconds, trace=trace, device=dev, t0=t0)
    ctx.update(cfg=cfg, mix=mix, cell=cell)
    print("portbench: set-up (s since start) " + json.dumps(ctx.get("setup_marks", [])), file=sys.stderr)
    if "trace" in ctx:
        t = ctx["trace"]
        print("portbench: traced " + json.dumps({k: t[k] for k in ("window_s", "busy_s", "kernels", "ranges", "groups")}),
              file=sys.stderr)
    metrics = {}
    for m in metrics_of(bench, cell, trace):
        value = load_module(root, "metrics", m["name"]).read(ctx)
        if value is None:
            print(f"portbench: {cell}: metric {m['name']} found nothing to read", file=sys.stderr)
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct, checks = verdict(ctx["compare"], limits)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1, "memory_peak_bytes": int(ctx["memory_peak_bytes"]),
    }
    result = {"correct": correct, "attempted": int(ctx["attempted"]), "failed": int(ctx["failed"]),
              "metrics": metrics, "device": device_info}
    if trace and "trace" in ctx:
        device_info.update(busy_s=ctx["trace"]["busy_s"], window_s=ctx["trace"]["window_s"])
        result["breakdown"] = ctx["trace"]["breakdown"]
    result["checks"] = checks
    gc.collect()
    return result


def main(argv=None, t0: float | None = None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    bench = load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA device(s), found {have}", file=sys.stderr)
        return 3
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, args.trace, "cuda", t0=t0)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
