"""Device readings of a traced run: a ``torch.profiler`` session over whole
steps or batches, reduced from its Chrome trace.

The benchmark marks the layers it reads with its own ranges
(``record_function("pb.<layer>")`` around the program's calls, from hooks
that this harness sets on the program's modules). A kernel belongs to the
range that was open on the host when it was launched: its launch (a CUDA
runtime or driver event) shares its ``correlation`` id. The records of each
kernel symbol are checked against the summed launch counters, over the same
session, of every wrapper that launches it; a group whose records do not
match is marked unchecked and the metrics that rest on it are not reported.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
PREFIX = "pb."
# kernel groups by the symbol the profiler records, each with the launch counters of every wrapper that launches
# that symbol: K1, K3 and K6 share one forward body (``flash_fwd_sm90_kernel`` in bf16, ``flash_fwd_f32`` in
# fp32), so their records are checked against the three counters' sum, whatever route the program takes
GROUPS = {
    "flash_fwd": ("flash_fwd", ("K1", "K3", "K6")), "flash_bwd_dkv": ("flash_bwd_dkv", ("K4",)),
    "flash_bwd_dq": ("flash_bwd_dq", ("K5",)), "mrf": ("mrf_stage_kernel", ("K2",)),
}


class Ranges:
    """Forward hooks that open ``pb.<name>`` around calls of a module."""

    def __init__(self):
        self._handles = []
        self._open = {}

    def around(self, module: torch.nn.Module, name: str) -> None:
        def pre(_m, _args):
            self._open[name] = torch.autograd.profiler.record_function(PREFIX + name)
            self._open[name].__enter__()

        def post(_m, _args, _out):
            self._open.pop(name).__exit__(None, None, None)

        self._handles += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


class Session:
    """One ``torch.profiler`` session: host operators and device activity,
    or with ``host=False`` the device activity and the CUDA API calls
    alone, which slows the host far less (the idle share is read there).
    ``stop(sync=False)`` ends it without waiting for the device, for a
    window that must not stall; kernels still running then may go
    unrecorded. ``events()`` exports the Chrome trace to a temporary file,
    reads it back and removes it."""

    def __init__(self, device: torch.device, host: bool = True):
        from torch.profiler import ProfilerActivity, profile

        self.cuda = device.type == "cuda"
        acts = ([ProfilerActivity.CPU] if host or not self.cuda else []) + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)

    def start(self, sync: bool = True) -> "Session":
        if sync and self.cuda:
            torch.cuda.synchronize()
        self.prof.start()
        return self

    def stop(self, sync: bool = True) -> None:
        if sync and self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()

    def events(self) -> list:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        return data["traceEvents"] if isinstance(data, dict) else data


def _complete(events, cats):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats and "dur" in e]


def busy_us(events) -> float:
    """The length of the union of the events' intervals (copied from the
    program's ``tools/read_trace.py``)."""
    total, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def reduce(events: list, launches: dict, top: int = 10, host_cats=HOST_CATS) -> dict:
    """The readings of one session. ``launches``: the launch counters'
    increase over the session (``program.launches_between``).

    Returns ``window_s`` (first host event to the last event's end),
    ``busy_s`` (union of device events), ``ranges`` (per ``pb.`` range name:
    how many, their kernels' device seconds and records), ``groups`` (per
    kernel symbol: records, device seconds, the launches of every counter
    that launches it and their summed bound, and ``checked``), and the
    ``breakdown``: the device operations that took most time and the idle
    gaps by the host range that was open when each began (``host_cats``
    says which host events count: operators and ranges, or the CUDA API
    calls of a device-only session)."""
    from portbench.counts.kernels import launch_bound_s

    dev = _complete(events, DEVICE_CATS)
    host = _complete(events, host_cats)
    launch_ts = {e["args"]["correlation"]: (e["ts"], e.get("tid")) for e in _complete(events, LAUNCH_CATS)
                 if "correlation" in e.get("args", {})}
    marks = sorted((e for e in host if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX)),
                   key=lambda e: e["ts"])
    starts = [e["ts"] for e in marks]

    def owner(ts):
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= marks[i]["ts"] + marks[i]["dur"]:
            return marks[i]["name"][len(PREFIX):]
        return None

    ranges = defaultdict(lambda: {"count": 0, "device_s": 0.0, "records": 0})
    for m in marks:
        ranges[m["name"][len(PREFIX):]]["count"] += 1
    by_name = defaultdict(lambda: [0, 0.0])
    for e in dev:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"] / 1e6
        corr = e.get("args", {}).get("correlation")
        name = owner(launch_ts[corr][0]) if corr in launch_ts else None
        if name is not None:
            ranges[name]["device_s"] += e["dur"] / 1e6
            ranges[name]["records"] += 1
    groups = {}
    for g, (needle, counters) in GROUPS.items():
        counted = {c: launches.get(c, {}) for c in counters}
        n_launch = sum(sum(v.values()) for v in counted.values())
        if not n_launch:
            continue
        recs = [e for e in dev if e.get("cat") == "kernel" and needle in e["name"]]
        groups[g] = {
            "records": len(recs), "launches": n_launch, "checked": len(recs) == n_launch,
            "device_s": sum(e["dur"] for e in recs) / 1e6,
            "bound_s": sum(n * launch_bound_s(c, v) for c, vs in counted.items() for v, n in vs.items()),
        }
    t0 = min((e["ts"] for e in host), default=0.0)
    t1 = max((e["ts"] + e["dur"] for e in dev + host), default=0.0)
    at = _HostIndex(host)
    gaps = defaultdict(float)
    end = None
    for e in sorted(dev, key=lambda e: e["ts"]):
        if end is not None and e["ts"] > end:
            gaps[at(end)] += (e["ts"] - end) / 1e6
        end = e["ts"] + e["dur"] if end is None else max(end, e["ts"] + e["dur"])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "window_s": (t1 - t0) / 1e6, "busy_s": busy_us(dev) / 1e6, "kernels": len(dev),
        "ranges": dict(ranges), "groups": groups,
        "breakdown": {"device_ops": [[n, s] for n, (_, s) in ops],
                      "idle_gaps": [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]},
    }


class _HostIndex:
    """The innermost host range of the busiest host thread open at a time:
    the latest-starting range that still holds it (ranges of one thread
    nest), looked for among the 256 that started last before it."""

    def __init__(self, host: list):
        tids = defaultdict(int)
        for e in host:
            tids[e.get("tid")] += 1
        main = max(tids, key=tids.get) if tids else None
        self.evs = sorted((e for e in host if e.get("tid") == main), key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in self.evs]

    def __call__(self, ts: float) -> str:
        i = bisect.bisect_right(self.starts, ts) - 1
        for j in range(i, max(i - 256, -1), -1):
            e = self.evs[j]
            if ts <= e["ts"] + e["dur"]:
                return e["name"]
        return "no host range"


def traced(device: torch.device, work, launch_counts) -> dict:
    """Run ``work`` twice under the profiler: with host operators (kernel
    attribution to the ``pb.`` ranges, record checks against
    ``launch_counts()``'s increase), then device-only (the window, busy
    time and breakdown, which host profiling would stretch)."""
    before = launch_counts()
    s = Session(device).start()
    work()
    s.stop()
    after = launch_counts()
    a = reduce(s.events(), {k: after[k] - before[k] for k in after})
    s = Session(device, host=False).start()
    work()
    s.stop()
    b = reduce(s.events(), {}, host_cats=LAUNCH_CATS)
    return {**a, "window_s": b["window_s"], "busy_s": b["busy_s"], "breakdown": b["breakdown"]}
