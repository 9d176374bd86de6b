"""Reader of the Chrome traces that ``utils/profiling.py trace_context``
writes (``<dir>/trace.json``), the port's counterpart of the repo's
``tools/read_xplane.py`` (the JAX profiler's XPlane reader): ranks the
device kernels by total time and count, the host's top-level ranges by
host time, and the program's spans (``program_span`` events) by host time.

    python -m audioldm_tpu_torch.tools.read_trace DIR_OR_TRACE_JSON [--top 25]

Device events are the trace's complete events of category ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; host ranges are those of ``cpu_op``,
``user_annotation`` and ``python_function``. A host range is top-level when
no other host range of its thread contains it. Prints the three tables and one
JSON line: the totals, the device's busy share of the traced span (the
union of its kernels' intervals over the span from the first host range's
start to the last event's end), and the top rows of each table.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
SPAN_CAT = "program_span"  # the program's spans (utils/profiling.py trace_context)


def find_trace(path: str) -> str:
    """``path`` itself, or the ``trace.json`` inside the directory ``path``."""
    if os.path.isdir(path):
        path = os.path.join(path, "trace.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no trace at {path}")
    return path


def _complete(events, cats):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats and "dur" in e]


def top_level(host: list) -> list:
    """The host ranges that no other range of their (pid, tid) contains."""
    out = []
    by_thread = defaultdict(list)
    for e in host:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for evs in by_thread.values():
        end = float("-inf")
        for e in sorted(evs, key=lambda e: (e["ts"], -e["dur"])):
            if e["ts"] >= end:
                out.append(e)
                end = e["ts"] + e["dur"]
    return out


def _rank(events) -> list:
    agg = defaultdict(lambda: [0, 0.0])
    for e in events:
        agg[e["name"]][0] += 1
        agg[e["name"]][1] += e["dur"]
    return [{"name": n, "count": c, "ms": us / 1e3} for n, (c, us) in sorted(agg.items(), key=lambda kv: -kv[1][1])]


def busy_us(events) -> float:
    """The length of the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def summarize(path: str, top: int = 25, out=None) -> dict:
    """The device kernels, top-level host ranges and program spans of a
    trace, ranked, printed to ``out`` (standard output by default)."""
    out = out or sys.stdout
    with open(find_trace(path)) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    dev, host = _complete(events, DEVICE_CATS), _complete(events, HOST_CATS)
    tops = top_level(host)
    spans = dev + host
    t0 = min((e["ts"] for e in host), default=0.0)
    t1 = max((e["ts"] + e["dur"] for e in spans), default=0.0)
    result = {
        "trace": find_trace(path), "device_events": len(dev), "device_ms": sum(e["dur"] for e in dev) / 1e3,
        "span_ms": (t1 - t0) / 1e3, "device_busy_share": busy_us(dev) / (t1 - t0) if t1 > t0 else None,
        "device_kernels": _rank(dev)[:top], "host_top_level": _rank(tops)[:top],
        "program_spans": _rank(_complete(events, (SPAN_CAT,)))[:top],
    }
    print(f"# {result['trace']}: {len(dev)} device events, {result['device_ms']:.3f} device ms over a span of "
          f"{result['span_ms']:.3f} ms (busy share {result['device_busy_share']})", file=out)
    for title, rows in (("device kernels", result["device_kernels"]), ("host top-level ranges", result["host_top_level"]),
                        ("program spans", result["program_spans"])):
        total = sum(r["ms"] for r in rows) or 1.0
        print(f"\n== {title}", file=out)
        for r in rows:
            print(f"  {r['ms']:10.3f} ms  {100 * r['ms'] / total:5.1f}%  x{r['count']:<6d} {r['name'][:90]}", file=out)
    print(json.dumps({"tool": "read_trace", **result}), file=out, flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", help="a trace directory (holding trace.json) or a trace file")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    summarize(args.path, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
