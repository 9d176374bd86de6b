"""Profiling hooks (port of audioldm_tpu/utils/profiling.py): a
``torch.profiler`` trace of a region, written as a Chrome trace, and named
ranges that show on the host and device timelines."""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]):
    """Capture a host and (on a GPU) device trace of the enclosed region into
    ``log_dir/trace.json`` (no-op when ``log_dir`` is None). Yields the
    profiler, or None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named range, usable as a context manager or a decorator."""
    return torch.profiler.record_function(name)
