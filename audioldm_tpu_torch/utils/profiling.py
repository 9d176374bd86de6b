"""The port's one tracing module: spans at its layer boundaries, counters
beside them, and a ``torch.profiler`` trace of a region that carries both.

    with span("gen.decode"):            # or @spanned("gen.decode") on a function
        ...
    count("engine.bank_gathers")
    enable(); ...; disable(); taken = drain()   # {"spans", "counters", "dropped"}
    with trace_context(log_dir): ...    # log_dir/trace.json, spans included

Spans are off by default, and then ``span`` returns one shared no-op
object: no allocation, no clock read, no ``record_function``. ``enable``,
``disable`` and ``drain`` are the only switch: the recorder is process-wide,
as the profiler is, because the layers that open spans (the sampler loop,
the UNet's blocks, the trainer) are not handed an object to record into.

On, a span records its id, name, start and end, the id of the span open
below it on the same thread (each thread keeps its own stack), the thread's
native id, a request key and its attributes. The key is given by the span
that starts a unit of work (the engine batch's ordinal, the optimizer step)
and inherited by every span opened inside it on that thread. Finished
spans go to a bounded in-memory buffer; past ``capacity`` they are counted
as dropped. Nothing is written until ``drain``.

The clock is the profiler's: ``time.time_ns()``, the system clock. A
``torch.profiler`` Chrome trace gives each event's ``ts`` in microseconds
after the trace's ``baseTimeNanoseconds`` on the same clock, so ``(ns -
base) / 1e3`` places a span on the trace's axis, where the kernels
launched inside it are (``trace_events``). Spans add no device
synchronisation and change no result.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from typing import Optional

import torch

clock = time.time_ns  # the profiler's clock (module docstring)
DEFAULT_CAPACITY = 1 << 16


class _Noop:
    """The span that tracing-off hands out: one shared object that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Recorder:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.spans: list = []
        self.counters: dict = {}
        self.dropped = 0
        self.lock = threading.Lock()
        self.local = threading.local()
        self.ids = itertools.count(1)

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def add(self, record: tuple) -> None:
        with self.lock:
            if len(self.spans) < self.capacity:
                self.spans.append(record)
            else:
                self.dropped += 1


class _Span:
    __slots__ = ("rec", "name", "key", "attrs", "id", "parent", "start")

    def __init__(self, rec: _Recorder, name: str, key, attrs: dict):
        self.rec, self.name, self.key, self.attrs = rec, name, key, attrs

    def __enter__(self):
        stack = self.rec.stack()
        up = stack[-1] if stack else None
        self.parent = up.id if up is not None else None
        if self.key is None and up is not None:
            self.key = up.key
        self.id = next(self.rec.ids)
        stack.append(self)
        self.start = clock()
        return self

    def __exit__(self, *exc):
        end = clock()
        self.rec.stack().pop()
        self.rec.add((self.id, self.name, self.start, end, self.parent, threading.get_native_id(), self.key,
                      self.attrs))
        return False


_recorder: Optional[_Recorder] = None  # the recorder spans go to while on
_held: Optional[_Recorder] = None  # the last recorder, kept for drain after disable


def span(name: str, key=None, **attrs):
    """A context manager around one layer's work; ``key`` (default: the
    enclosing span's) ties the spans of one batch or step together."""
    rec = _recorder
    if rec is None:
        return _NOOP
    return _Span(rec, name, key, attrs)


def spanned(name: str, **attrs):
    """``span`` as a decorator: each call of the function is one span (on
    or off is decided at each call, so a function decorated at import is
    traced once spans are on)."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name, **attrs):
                return fn(*args, **kwargs)

        return inner

    return wrap


def record(name: str, start_ns: int, end_ns: int, key=None, **attrs) -> None:
    """A span measured by its caller, on ``clock``, that no stack holds (a
    request's wait from one thread's submit to another's batch)."""
    rec = _recorder
    if rec is not None:
        rec.add((next(rec.ids), name, start_ns, end_ns, None, threading.get_native_id(), key, attrs))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while spans are on."""
    rec = _recorder
    if rec is not None:
        with rec.lock:
            rec.counters[name] = rec.counters.get(name, 0) + n


def enabled() -> bool:
    return _recorder is not None


def enable(capacity: int = DEFAULT_CAPACITY) -> None:
    """Start recording (into a fresh buffer of ``capacity`` spans, unless
    already on)."""
    global _recorder, _held
    if _recorder is None:
        _recorder = _held = _Recorder(capacity)


def disable() -> None:
    """Stop recording; what was recorded stays for ``drain``."""
    global _recorder
    _recorder = None


def drain() -> dict:
    """The finished spans (in the order they ended), the counters and the
    number of spans dropped since the last drain, which empties them."""
    rec = _held
    if rec is None:
        return {"spans": [], "counters": {}, "dropped": 0}
    with rec.lock:
        spans, counters, dropped = rec.spans, rec.counters, rec.dropped
        rec.spans, rec.counters, rec.dropped = [], {}, 0
    keys = ("id", "name", "start_ns", "end_ns", "parent", "thread", "key", "attrs")
    return {"spans": [dict(zip(keys, s)) for s in spans], "counters": counters, "dropped": dropped}


def trace_events(taken: dict, base_ns: int) -> list:
    """``drain``'s spans as Chrome-trace complete events of category
    ``program_span`` on a trace whose ``baseTimeNanoseconds`` is ``base_ns``."""
    pid = os.getpid()
    return [{"ph": "X", "cat": "program_span", "name": s["name"], "pid": pid, "tid": s["thread"],
             "ts": (s["start_ns"] - base_ns) / 1e3, "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
             "args": {"id": s["id"], "parent": s["parent"], "key": s["key"], **s["attrs"]}}
            for s in taken["spans"]]


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]):
    """Capture a host and (on a GPU) device trace of the enclosed region into
    ``log_dir/trace.json`` (no-op when ``log_dir`` is None), with the
    program's spans turned on for the region and written into the same file
    (``trace_events``; the counters under ``programCounters``, the dropped
    spans under ``programSpansDropped``). Spans already on belong to whoever
    turned them on: they stay on and out of this file. Yields the profiler,
    or None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    owner = not enabled()
    if owner:
        drain()  # what an earlier region left undrained is not this one's
        enable()
    try:
        if cuda:
            torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            yield prof
            if cuda:
                torch.cuda.synchronize()
    finally:
        if owner:
            disable()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    if owner:
        taken = drain()
        with open(path) as f:
            trace = json.load(f)
        trace["traceEvents"].extend(trace_events(taken, int(trace.get("baseTimeNanoseconds", 0))))
        trace.update(programCounters=taken["counters"], programSpansDropped=taken["dropped"])
        with open(path, "w") as f:
            json.dump(trace, f)
