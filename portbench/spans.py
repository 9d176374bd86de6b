"""Readings of the program's own spans (``audioldm_tpu_torch/utils/profiling.py``)
in a traced run, on the device trace's clock.

``traced(device, work, launch_counts)`` is ``trace.traced`` with the
program's spans on for its two sessions only: what ``trace.traced`` returns
(every key as it reads it), the device-only session's ``idle_gaps`` with
each gap that reads ``no host range`` named after the innermost program
span open when it began (the others keep their names; the total is the
same), and ``spans``, the readings below of the device-only session.

Per span name (``reduce``): ``count``, ``host_ms`` and ``self_ms`` (less
its children), the device ms and records of the device operations whose
launch fell inside the span or a span inside it (by correlation id, as
``trace.reduce`` owns kernels), ``self_device_ms`` (those launched in no
span inside it), ``idle_ms`` (the part of the span in
which the device ran nothing, within the session's window) and the top 3
device operations. ``idle_ms`` of the session and the share of it inside
some span come beside them.

The same kernel ownership is read in the session with host operators
(``host_session``: device ms, self device ms and records per name), where
``trace.reduce`` reads the ``pb.`` ranges, so that a span's device time and
a range's compare within one session.

``reading(ctx, name)`` reads one per-layer metric from ``ctx["trace"]``:
``step_device_ms.gen`` (from ``host_session``, when the flash forward's
records match the counters there), ``step_idle_ms.gen``,
``batch_idle_ms.gen``, ``step_idle_ms.train`` (None where the spans or the
device are missing).

The harness's drivers call ``trace.traced``; until they call ``traced``
here, ``python3 portbench/spans.py --workload <cell> --seed <n> --seconds
<s>`` runs a cell as ``--trace 1`` does with ``traced`` in its place and
prints the result line with the readings, and ``portbench: spans {...}``
on standard error.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__" and sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

from audioldm_tpu_torch.utils import profiling  # noqa: E402
from portbench import trace as tr  # noqa: E402

NO_RANGE = "no host range"
METRICS = ("step_device_ms.gen", "step_idle_ms.gen", "batch_idle_ms.gen", "step_idle_ms.train")


def export(session: tr.Session) -> tuple[list, int]:
    """A session's Chrome-trace events and its ``baseTimeNanoseconds`` (0
    where the trace gives absolute times)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        session.prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    if isinstance(data, list):
        return data, 0
    return data["traceEvents"], int(data.get("baseTimeNanoseconds", 0))


def on_axis(taken: dict, base_ns: int) -> list:
    """The recorder's spans in the trace's microseconds: ``{id, name,
    parent, key, thread, ts, end}``."""
    return [{"id": s["id"], "name": s["name"], "parent": s["parent"], "key": s["key"], "thread": s["thread"],
             "ts": (s["start_ns"] - base_ns) / 1e3, "end": (s["end_ns"] - base_ns) / 1e3} for s in taken["spans"]]


class Innermost:
    """The innermost span open at a time, among the spans of the thread
    that holds most of them (spans of one thread nest): the spans cut into
    disjoint segments, each named by its innermost span."""

    def __init__(self, spans: list):
        threads = defaultdict(int)
        for s in spans:
            threads[s["thread"]] += 1
        main = max(threads, key=threads.get) if threads else None
        self.segs = []
        stack, t = [], float("-inf")
        for s in sorted((s for s in spans if s["thread"] == main), key=lambda s: (s["ts"], -s["end"])):
            while stack and stack[-1]["end"] <= s["ts"]:
                top = stack.pop()
                if top["end"] > t:
                    self.segs.append((max(t, top["ts"]), top["end"], top))
                    t = top["end"]
            if stack and s["ts"] > t:
                self.segs.append((t, s["ts"], stack[-1]))
            t = max(t, s["ts"])
            stack.append(s)
        while stack:
            top = stack.pop()
            if top["end"] > t:
                self.segs.append((max(t, top["ts"]), top["end"], top))
                t = top["end"]
        self.starts = [seg[0] for seg in self.segs]

    def __call__(self, ts: float):
        i = bisect.bisect_right(self.starts, ts) - 1
        if i >= 0 and ts < self.segs[i][1]:
            return self.segs[i][2]
        return None


def idle_intervals(events: list, host_cats) -> tuple[list, float, float]:
    """The device's idle intervals inside the session's window (as
    ``trace.reduce`` takes it: the first host event's start to the last
    event's end), and the window's ends."""
    dev = tr._complete(events, tr.DEVICE_CATS)
    host = tr._complete(events, host_cats)
    t0 = min((e["ts"] for e in host), default=0.0)
    t1 = max((e["ts"] + e["dur"] for e in dev + host), default=0.0)
    out, at = [], t0
    for e in sorted(dev, key=lambda e: e["ts"]):
        if e["ts"] > at:
            out.append((at, min(e["ts"], t1)))
        at = max(at, e["ts"] + e["dur"])
    if t1 > at:
        out.append((at, t1))
    return out, t0, t1


def _overlap(intervals: list, starts: list, a: float, b: float) -> float:
    """Length of the sorted disjoint ``intervals`` inside ``[a, b]``."""
    total = 0.0
    for lo, hi in intervals[max(bisect.bisect_right(starts, a) - 1, 0):]:
        if lo >= b:
            break
        total += max(0.0, min(hi, b) - max(lo, a))
    return total


def _union(intervals: list) -> list:
    """The union of ``intervals`` as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce(events: list, spans: list, host_cats=tr.LAUNCH_CATS, top: int = 3) -> dict:
    """The per-span readings of one session (module docstring); ``spans``
    on the trace's axis (``on_axis``)."""
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in tr._complete(events, tr.LAUNCH_CATS)
                 if "correlation" in e.get("args", {})}
    inner = Innermost(spans)
    by_id = {s["id"]: s for s in spans}
    rows = defaultdict(lambda: {"count": 0, "host_ms": 0.0, "self_ms": 0.0, "device_ms": 0.0, "self_device_ms": 0.0,
                                "records": 0, "idle_ms": 0.0, "ops": defaultdict(float)})
    child_us = defaultdict(float)
    for s in spans:
        if s["parent"] in by_id:
            child_us[s["parent"]] += s["end"] - s["ts"]
    idle, t0, t1 = idle_intervals(events, host_cats)
    idle_starts = [lo for lo, _ in idle]
    for s in spans:
        r = rows[s["name"]]
        r["count"] += 1
        r["host_ms"] += (s["end"] - s["ts"]) / 1e3
        r["self_ms"] += (s["end"] - s["ts"] - child_us[s["id"]]) / 1e3
        r["idle_ms"] += _overlap(idle, idle_starts, s["ts"], s["end"]) / 1e3
    for e in tr._complete(events, tr.DEVICE_CATS):
        corr = e.get("args", {}).get("correlation")
        s = inner(launch_ts[corr]) if corr in launch_ts else None
        if s is not None:
            rows[s["name"]]["self_device_ms"] += e["dur"] / 1e3
        names = set()
        while s is not None:  # the owner and every span around it, each name once
            names.add(s["name"])
            s = by_id.get(s["parent"])
        for n in names:
            rows[n]["device_ms"] += e["dur"] / 1e3
            rows[n]["records"] += 1
            rows[n]["ops"][e["name"]] += e["dur"] / 1e3
    idle_ms = sum(hi - lo for lo, hi in idle) / 1e3
    in_spans = sum(_overlap(idle, idle_starts, a, b) for a, b in _union([(s["ts"], s["end"]) for s in spans])) / 1e3
    out = {}
    for n, r in rows.items():
        ops = sorted(r.pop("ops").items(), key=lambda kv: -kv[1])[:top]
        out[n] = {**r, "top_ops": [[k, v] for k, v in ops]}
    return {"idle_ms": idle_ms, "idle_in_spans_ms": in_spans, "window_ms": (t1 - t0) / 1e3, "by_name": out}


def launches_outside(events: list, spans: list, name: str):
    """CUDA calls that began between the first and the last span ``name``
    but inside none of them (None without such a span): 0 where the spans
    of consecutive steps leave no launch to their parents."""
    mine = sorted((s["ts"], s["end"]) for s in spans if s["name"] == name)
    if not mine:
        return None
    starts = [a for a, _ in mine]
    n = 0
    for e in tr._complete(events, tr.LAUNCH_CATS):
        if mine[0][0] <= e["ts"] <= mine[-1][1]:
            i = bisect.bisect_right(starts, e["ts"]) - 1
            n += not (i >= 0 and e["ts"] <= mine[i][1])
    return n


def rename_gaps(events: list, spans: list, host_cats=tr.LAUNCH_CATS, top: int = 10) -> list:
    """``trace.reduce``'s idle gaps, each that began with no host range open
    named after the innermost program span open then (``no host range``
    where there is none either)."""
    dev = tr._complete(events, tr.DEVICE_CATS)
    at_host, inner = tr._HostIndex(tr._complete(events, host_cats)), Innermost(spans)
    gaps = defaultdict(float)
    end = None
    for e in sorted(dev, key=lambda e: e["ts"]):
        if end is not None and e["ts"] > end:
            name = at_host(end)
            if name == NO_RANGE:
                s = inner(end)
                name = s["name"] if s is not None else NO_RANGE
            gaps[name] += (e["ts"] - end) / 1e6
        end = e["ts"] + e["dur"] if end is None else max(end, e["ts"] + e["dur"])
    return [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]


def traced(device, work, launch_counts) -> dict:
    """``trace.traced`` with the program's spans on in both sessions
    (module docstring)."""

    def session(host: bool):
        before = launch_counts()
        s = tr.Session(device, host=host).start()
        profiling.drain()
        profiling.enable()
        try:
            work()
        finally:
            profiling.disable()
        s.stop()
        after = launch_counts()
        events, base = export(s)
        return events, on_axis(profiling.drain(), base), {k: after[k] - before[k] for k in after}

    ev_a, spans_a, launches_a = session(True)
    a = tr.reduce(ev_a, launches_a)
    # the session with host operators, where the ``pb.`` ranges' device time is read: device ms there
    host = {n: {k: r[k] for k in ("count", "device_ms", "self_device_ms", "records")}
            for n, r in reduce(ev_a, spans_a, host_cats=tr.HOST_CATS)["by_name"].items()}
    del ev_a, spans_a  # as ``trace.traced``, nothing of the first session stays alive through the second
    ev_b, spans_b, launches_b = session(False)
    b = tr.reduce(ev_b, launches_b, host_cats=tr.LAUNCH_CATS)
    readings = reduce(ev_b, spans_b)
    readings["groups_checked"] = {g: v["checked"] for g, v in b["groups"].items()}
    readings["host_session"] = host
    readings["host_groups_checked"] = {g: v["checked"] for g, v in a["groups"].items()}
    readings["launches_outside"] = {n: launches_outside(ev_b, spans_b, n) for n in ("gen.step", "train.step")}
    return {**a, "window_s": b["window_s"], "busy_s": b["busy_s"],
            "breakdown": {**b["breakdown"], "idle_gaps": rename_gaps(ev_b, spans_b)}, "spans": readings}


def reading(ctx: dict, name: str):
    """The per-layer metric ``name`` (``METRICS``) of a traced run, or None."""
    sp = (ctx.get("trace") or {}).get("spans")
    if sp is None or not sp["by_name"]:
        return None
    rows = sp["by_name"]
    kind = {"step_device_ms.gen": "gen.step", "step_idle_ms.gen": "gen.step", "batch_idle_ms.gen": "gen.step",
            "step_idle_ms.train": "train.step"}[name]
    r = rows.get(kind)
    if r is None or not r["count"] or not any(v["records"] for v in rows.values()):
        return None  # no such span, or no device operation seen (the CPU)
    if name == "step_device_ms.gen":  # in the session where denoise_step_device_ms.gen is read, so comparable
        h = sp.get("host_session", {}).get(kind)
        ok = h is not None and h["count"] and sp.get("host_groups_checked", {}).get("flash_fwd")
        return h["device_ms"] / h["count"] if ok else None
    if name == "batch_idle_ms.gen":
        return sp["idle_ms"] - r["idle_ms"]
    return r["idle_ms"] / r["count"]


def line(readings: dict) -> dict:
    """The ``portbench: spans`` line: per span name, the numbers rounded to
    the microsecond and the top operations' names cut to 60 characters."""
    rows = {n: {k: (round(v, 3) if isinstance(v, float) else v) for k, v in r.items() if k != "top_ops"}
            | {"top_ops": [[op[:60], round(ms, 3)] for op, ms in r["top_ops"]]} for n, r in readings["by_name"].items()}
    host = {n: round(r["device_ms"], 3) for n, r in readings.get("host_session", {}).items()}
    return {"idle_ms": round(readings["idle_ms"], 3), "idle_in_spans_ms": round(readings["idle_in_spans_ms"], 3),
            "launches_outside": readings.get("launches_outside"), "by_name": rows, "host_session_device_ms": host}


def run_cell(root: str, cell: str, seed: int, seconds: float, device: str = "cuda", overrides: dict | None = None):
    """``harness.run_cell`` with ``--trace 1`` and ``traced`` in place of
    ``trace.traced``: ``(result, the traced sessions' reduction)``, the
    result holding the readings under ``spans`` (None each without spans)."""
    from portbench import harness

    got = {}

    def keeping(*args):
        got["trace"] = traced(*args)
        return got["trace"]

    own, tr.traced = tr.traced, keeping
    try:
        result = harness.run_cell(root, cell, seed, seconds, 1, device, overrides=overrides)
    finally:
        tr.traced = own
    t = got.get("trace", {})
    result["spans"] = {m: reading({"trace": t}, m) for m in METRICS}
    return result, t


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell as --trace 1 does, with the program's spans read.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", help="write the whole spans reading here as JSON")
    args = ap.parse_args(argv)
    result, t = run_cell(ROOT, args.workload, args.seed, args.seconds)
    if "spans" in t:
        print("portbench: spans " + json.dumps(line(t["spans"])), file=sys.stderr)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"workload": args.workload, "seed": args.seed, "result": result, "spans": t["spans"]}, f)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
