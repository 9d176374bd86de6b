"""CPU tests of ``portbench/spans.py``: the program's spans read on a
synthetic device trace, and a tiny traced run of each kind of cell with
them, where no device operation runs and the four readings report nothing.

    python -m pytest portbench/tests/test_spans.py -q
"""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import spans as sp  # noqa: E402
from portbench import trace as tr  # noqa: E402
from portbench.tests.test_portbench import GEN_CELLS, SEED, TRAIN_CELL, overrides  # noqa: E402


def _x(name, cat, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(i, name, ts, end, parent=None):
    return {"id": i, "name": name, "parent": parent, "key": 1, "thread": 9, "ts": ts, "end": end}


# A batch of two steps on one host thread (spans) and a device-only session's events (launches and kernels):
# batch [0, 100]: text [0, 10], step [10, 40] holding unet [12, 30], step [40, 70] holding unet [42, 60],
# decode [70, 95]. Kernels: text 2-8, unet 14-34 (launched at 13), sampler 36-39 (launched at 32), unet 44-62,
# decode 75-90 (launched at 71); a cudaStreamSynchronize at 61-63 launches nothing. The window is the first launch
# (1) to the last event's end (90, the last kernel's: spans are not events of the trace).
SPANS = [_span(1, "batch", 0, 100), _span(2, "text", 0, 10, 1), _span(3, "gen.step", 10, 40, 1),
         _span(4, "unet", 12, 30, 3), _span(5, "gen.step", 40, 70, 1), _span(6, "unet", 42, 60, 5),
         _span(7, "decode", 70, 95, 1)]
EVENTS = [
    _x("cudaLaunchKernel", "cuda_runtime", 1, 1, corr=1), _x("k_text", "kernel", 2, 6, corr=1, tid=7),
    _x("cudaLaunchKernel", "cuda_runtime", 13, 1, corr=2), _x("k_unet", "kernel", 14, 20, corr=2, tid=7),
    _x("cudaLaunchKernel", "cuda_runtime", 32, 1, corr=3), _x("k_ddim", "kernel", 36, 3, corr=3, tid=7),
    _x("cudaLaunchKernel", "cuda_runtime", 43, 1, corr=4), _x("k_unet", "kernel", 44, 18, corr=4, tid=7),
    _x("cudaStreamSynchronize", "cuda_runtime", 61, 2),
    _x("cudaLaunchKernel", "cuda_runtime", 71, 3, corr=5), _x("k_dec", "kernel", 75, 15, corr=5, tid=7),
]


def test_kernels_go_to_the_span_open_at_their_launch_and_to_every_span_around_it():
    r = sp.reduce(EVENTS, SPANS)["by_name"]
    assert r["gen.step"]["count"] == 2 and r["gen.step"]["records"] == 3
    assert r["gen.step"]["device_ms"] == pytest.approx((20 + 3 + 18) / 1e3)
    assert r["unet"]["device_ms"] == pytest.approx((20 + 18) / 1e3)  # the kernel running past unet's end stays unet's
    assert r["text"]["records"] == 1 and r["decode"]["records"] == 1 and r["batch"]["records"] == 5
    assert r["gen.step"]["top_ops"][0] == ["k_unet", pytest.approx(0.038)]
    assert r["gen.step"]["host_ms"] == pytest.approx(0.06) and r["gen.step"]["self_ms"] == pytest.approx(0.024)
    assert r["batch"]["self_ms"] == pytest.approx(0.1 - 0.095)
    assert r["gen.step"]["self_device_ms"] == pytest.approx(0.003) and r["unet"]["self_device_ms"] == r["unet"]["device_ms"]
    assert r["batch"]["self_device_ms"] == 0.0


def test_idle_splits_inside_and_outside_the_steps_and_adds_up():
    out = sp.reduce(EVENTS, SPANS)
    dev = tr._complete(EVENTS, tr.DEVICE_CATS)
    base = tr.reduce(EVENTS, {}, host_cats=tr.LAUNCH_CATS)
    # idle: [1, 2], [8, 14], [34, 36], [39, 44], [62, 75] in a window [1, 90]
    assert out["idle_ms"] == pytest.approx(1e3 * (base["window_s"] - base["busy_s"]))
    assert out["idle_ms"] == pytest.approx((1 + 6 + 2 + 5 + 13) / 1e3)
    r = out["by_name"]
    # [10, 14], [34, 36], [39, 40] in the first step; [40, 44], [62, 70] in the second
    assert r["gen.step"]["idle_ms"] == pytest.approx((4 + 2 + 1 + 4 + 8) / 1e3)
    assert r["decode"]["idle_ms"] == pytest.approx(5 / 1e3)
    steps_idle, outside = r["gen.step"]["idle_ms"], out["idle_ms"] - r["gen.step"]["idle_ms"]
    assert steps_idle + outside == pytest.approx(out["idle_ms"])
    assert out["idle_in_spans_ms"] == pytest.approx(out["idle_ms"])  # the batch span covers the window
    assert len(dev) == 5
    host = {n: {k: v[k] for k in ("count", "device_ms", "self_device_ms", "records")} for n, v in r.items()}
    ctx = {"trace": {"spans": {**out, "groups_checked": {}, "host_session": host, "host_groups_checked": {"flash_fwd": True}}}}
    assert sp.reading(ctx, "step_idle_ms.gen") == pytest.approx(steps_idle / 2)
    assert sp.reading(ctx, "batch_idle_ms.gen") == pytest.approx(outside)
    assert sp.reading(ctx, "step_device_ms.gen") == pytest.approx(0.041 / 2)
    assert sp.reading(ctx, "step_idle_ms.train") is None  # no train.step span
    ctx["trace"]["spans"]["host_groups_checked"] = {"flash_fwd": False}
    assert sp.reading(ctx, "step_device_ms.gen") is None  # records that do not match the counters


def test_no_host_range_gaps_take_the_span_open_and_the_rest_keep_their_names():
    plain = dict(tr.reduce(EVENTS, {}, host_cats=tr.LAUNCH_CATS)["breakdown"]["idle_gaps"])
    named = dict(sp.rename_gaps(EVENTS, SPANS))
    # the gap after k_text (8 -> 14) began in "text", after the unet kernel (34 -> 36) in the first step, after
    # k_ddim (39 -> 44) in the second step, after the second unet kernel (62 -> 75) inside a CUDA call
    assert plain == pytest.approx({"no host range": (6 + 2 + 5) / 1e6, "cudaStreamSynchronize": 13 / 1e6})
    assert named == pytest.approx({"text": 6 / 1e6, "gen.step": 7 / 1e6, "cudaStreamSynchronize": 13 / 1e6})
    assert sum(named.values()) == pytest.approx(sum(plain.values()))
    assert dict(sp.rename_gaps(EVENTS, [])) == pytest.approx(plain)  # no span: the names stay


def test_launches_between_the_steps_but_outside_them_are_counted():
    assert sp.launches_outside(EVENTS, SPANS, "gen.step") == 0
    assert sp.launches_outside(EVENTS, SPANS[:3], "gen.step") == 0  # one step: nothing between
    split = SPANS[:2] + [_span(3, "gen.step", 10, 30, 1), _span(5, "gen.step", 40, 70, 1)]
    assert sp.launches_outside(EVENTS, split, "gen.step") == 1  # the launch at 32
    assert sp.launches_outside(EVENTS, SPANS, "train.step") is None


def test_nested_and_sibling_spans_cut_into_innermost_segments():
    inner = sp.Innermost(SPANS)
    assert [inner(t)["name"] if inner(t) else None for t in (0, 5, 11, 20, 35, 41, 65, 80, 99, 100, 150)] == [
        "text", "text", "gen.step", "unet", "gen.step", "gen.step", "gen.step", "decode", "batch", None, None]


@pytest.mark.parametrize("cell", (GEN_CELLS[0], TRAIN_CELL))
def test_a_traced_run_with_spans_reports_the_tree_and_nothing_on_the_cpu(cell):
    result, t = sp.run_cell(ROOT, cell, SEED, 0.2, "cpu", overrides=overrides(cell))
    assert result["correct"] is True
    assert result["spans"] == {m: None for m in sp.METRICS}  # no device operation ran
    names = t["spans"]["by_name"]
    if cell == TRAIN_CELL:
        assert names["train.step"]["count"] == 3 and names["train.fit"]["count"] == 1
        assert {"train.encode", "train.text", "train.loss", "train.backward", "train.optim", "unet.mid"} <= set(names)
    else:
        steps = overrides(cell)["traffic"]["steps"]
        assert names["gen.step"]["count"] == steps and names["engine.generate"]["count"] == 1
        assert names["unet.down.0"]["count"] == steps
    assert set(t) >= {"window_s", "busy_s", "kernels", "ranges", "groups", "breakdown"}
    assert not sp.profiling.enabled()
    assert tr.traced.__module__ == "portbench.trace" and tr.traced.__name__ == "traced"  # put back
