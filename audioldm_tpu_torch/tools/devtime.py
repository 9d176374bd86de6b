"""The device time of one kernel's launch, read so that a faulty profiler
record cannot pass for it, and a probe of the profiler's records.

    python -m audioldm_tpu_torch.tools.devtime [PHASES]      (from the repo root, on the GPU)

``kernel_ms`` reads torch.profiler's records of the kernel under test
only, by its function name, and takes a session only when they are sound:
at least half the calls recorded, the longest within 1.25x the shortest
(one launch on the same inputs), and their median within 10% of
``graph_ms``, the time a call of a CUDA graph of the same calls replayed
(no host between launches; about 1 µs of launch gap a kernel). Sessions
were seen to keep only 6 of 10 records late in a long process, and to hold
records of half or 1.1x the launch's time, in ``chip_smoke.py`` and in a
fresh process alike; a per-kernel mean of every row takes those in.

The probe runs ``chip_smoke.py``'s phases ``PHASES`` first (default
``diag``; ``kernels,serve,train,samplers,a2a,diag`` for the state a full
run leaves the profiler in), then for K1 at ``[2, 8, 2048, 16]`` and K8,
K9 and K10 at the tool's shapes prints one JSON line: the time a call from
CUDA events over back-to-back calls (the host's pace where it is the
slower), ``graph_ms``, ``kernel_ms``, and for three profiler sessions of 10
calls the kernel's records: how many, their mean, median, shortest and
longest, the span from the first start to the last end, the CUDA-event
window of the session, and the gaps between the first records.
"""

from __future__ import annotations

import json
import statistics
import sys

import torch
from torch.profiler import ProfilerActivity, profile


def events_ms(fn, iters: int = 50) -> float:
    """Time a call from CUDA events over ``iters`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters: int = 10, reps: int = 20) -> float:
    """Time a call of a CUDA graph of ``iters`` calls of ``fn`` (captured
    after a call on a side stream), replayed ``reps`` times between CUDA
    events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * iters)


def records(fn, kernel: str, iters: int = 10) -> tuple[list, float]:
    """One profiler session of ``iters`` calls of ``fn``: the (start, end)
    in µs of each record of a kernel whose name holds ``kernel``, in order,
    and the session's CUDA-event window in µs."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
    mine = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                  if str(e.device_type).endswith("CUDA") and kernel in e.name)
    return mine, a.elapsed_time(b) * 1e3


def kernel_ms(fn, kernel: str, iters: int = 10, sessions: int = 3) -> tuple[float | None, str]:
    """The device time in ms of one launch of ``kernel`` by ``fn`` (which
    launches it once a call), with what the sessions held: the median of
    the first sound session's records (module docstring), or None."""
    graph = graph_ms(fn) * 1e3
    seen = []
    for _ in range(sessions):
        mine, _ = records(fn, kernel, iters)
        d = [end - start for start, end in mine]
        seen.append(f"{len(d)} records ({min(d, default=0):.2f}-{max(d, default=0):.2f} us)")
        if 2 * len(d) >= iters and max(d) <= 1.25 * min(d) and abs(statistics.median(d) - graph) <= 0.1 * graph:
            return statistics.median(d) / 1e3, f"{seen[-1]} of {iters} calls, graph {graph:.2f} us a call"
    return None, f"{'; '.join(seen)} in sessions of {iters} calls, graph {graph:.2f} us a call"


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("devtime: no CUDA GPU available", file=sys.stderr)
        return 1
    import chip_smoke as cs

    from audioldm_tpu_torch.kernels import attn_diag as ad
    from audioldm_tpu_torch.kernels import flash_attention as fa

    phases = argv[0] if argv else "diag"
    sys.argv = ["chip_smoke.py", phases]
    rc = cs.main()
    print(json.dumps({"phases": phases, "chip_smoke_rc": rc}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = (("K1", (2, 8, 2048, 16), lambda q, k, v: fa.flash_attention(q, k, v), "flash_fwd_sm90_kernel"),
             ("K8", (2, 8, 4096, 16), lambda q, k, v: ad.fori_exp2(q, k, v, 64, 64), "attn_diag_sm90_kernel"),
             ("K9", (2, 8, 512, 64), lambda q, k, v: ad.grid3(q, k, v, 64, 64), "attn_diag_sm90_kernel"),
             ("K10", (2, 8, 4096, 16), lambda q, k, v: ad.grid3b(q, k, v, 64, 64), "attn_diag_sm90_kernel"))
    for name, shape, fn, kernel in cases:
        q, k, v = (torch.randn(shape, device="cuda", generator=gen).bfloat16() for _ in range(3))
        call = lambda: fn(q, k, v)
        out = {"kernel": name, "shape": list(shape), "events_ms": events_ms(call), "graph_ms": graph_ms(call),
               "kernel_ms": kernel_ms(call, kernel), "sessions": []}
        for _ in range(3):
            mine, window = records(call, kernel)
            d = [end - start for start, end in mine]
            out["sessions"].append({
                "records": len(d), "mean_us": statistics.mean(d) if d else None,
                "median_us": statistics.median(d) if d else None, "min_us": min(d, default=None),
                "max_us": max(d, default=None), "span_us": mine[-1][1] - mine[0][0] if d else None, "window_us": window,
                "gaps_us": [mine[i + 1][0] - mine[i][1] for i in range(min(len(mine) - 1, 4))]})
        print(json.dumps(out), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
