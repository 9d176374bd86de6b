"""CPU tests of the port's benchmark harness (``portbench``), at tiny widths.

    python -m pytest portbench/tests -q

Each traffic driver runs a whole cell through the harness on the CPU; a
cell is added from new files only; the comparison fails the lower-precision
controls and planted faults of the timed path; the counts equal the
program's; no run loads JAX or the JAX package. Tests marked ``gpu`` run the
controls on the card and skip without one.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import compare, control, harness  # noqa: E402
from portbench.tests import tiny  # noqa: E402

GEN_CELLS = ("bf16.t2a-ddim50-b16", "fp32.t2a-ddim50-b16")
TRAIN_CELL = "bf16.lora-train-b32"
SEED = 2**31 + 12345  # more than 32 signed bits hold, as the driver's seeds


def overrides(cell: str, root: str = ROOT) -> dict:
    """Tiny widths, short mixes and the tiny cells' limits (``tiny.py``)."""
    bench = harness.load_json(root, "BENCHMARK.json")
    _, cfg, mix, _ = harness.cell_parts(root, bench, cell)
    return {"config": tiny.config_overrides(cfg), "traffic": tiny.MIXES[mix["driver"]], "limits": limits(cell)}


def run(cell: str, trace: int = 0, root: str = ROOT) -> dict:
    return harness.run_cell(root, cell, SEED, 0.2, trace, "cpu", overrides=overrides(cell, root))


def limits(cell: str) -> dict:
    """The tiny cell's limits."""
    return {k: {"limit": v} for k, v in tiny.LIMITS[cell].items()}


@pytest.mark.parametrize("cell", GEN_CELLS + (TRAIN_CELL,))
def test_cell_runs_on_the_cpu_and_is_correct(cell):
    res = run(cell)
    assert res["correct"] is True, res["checks"]
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    want = {m["name"] for m in harness.metrics_of(bench, cell, 0)}
    assert set(res["metrics"]) == want and "setup_s" in want
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"  # never a device metric's name on a CPU number


@pytest.mark.parametrize("cell", (GEN_CELLS[0], TRAIN_CELL))
def test_traced_run_reports_no_device_metric_on_the_cpu(cell):
    res = run(cell, trace=1)
    assert res["correct"] is True
    device_metrics = {"denoise_step_device_ms.gen", "launches_per_step.gen", "decode_device_ms.gen",
                      "flash_fwd_roofline.gen", "mrf_roofline.gen", "device_idle_share.gen",
                      "train_step_device_ms.train", "launches_per_step.train", "flash_bwd_roofline.train",
                      "device_idle_share.train"}
    assert not device_metrics & set(res["metrics"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_run_loads_neither_jax_nor_the_jax_package():
    run(GEN_CELLS[0])
    assert harness.forbidden_modules(sys.modules) == []
    assert harness.forbidden_modules(["audioldm_tpu_torch.models", "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["jax.numpy", "audioldm_tpu", "flax.linen", "jaxlib"]) == [
        "audioldm_tpu", "flax.linen", "jax.numpy", "jaxlib"]


def test_reference_imports_nothing_of_the_program_or_jax():
    ref_dir = os.path.join(ROOT, "portbench", "reference")
    seen = set()
    for name in os.listdir(ref_dir):
        if name.endswith(".py"):
            tree = ast.parse(open(os.path.join(ref_dir, name)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    seen |= {a.name.split(".", 1)[0] for a in node.names}
                elif isinstance(node, ast.ImportFrom) and node.module:
                    seen.add(node.module.split(".", 1)[0])
    assert seen, "no imports found"
    assert not seen & {"jax", "jaxlib", "flax", "audioldm_tpu", "audioldm_tpu_torch"}, seen


def test_a_cell_is_added_from_new_files_only(tmp_path):
    """A new configuration, traffic mix, metric and limits file, and new
    entries in BENCHMARK.json: the harness runs the new cell and reads the
    new metric without a change to any existing file."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(os.path.join(root, "portbench", p), "rb").read() for p in _files(root / "portbench")}
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    cfg = harness.load_json(ROOT, "portbench", "configs", "audioldm-s-full-v2.bf16.json")
    cfg["lora"] = {**cfg["lora"], "target_modules": ["to_q", "to_k", "to_v"]}
    (root / "portbench" / "configs" / "new-config.json").write_text(json.dumps(cfg))
    mix = harness.load_json(ROOT, "portbench", "traffic", "t2a-ddim50-b16.json")
    (root / "portbench" / "traffic" / "new-mix.json").write_text(json.dumps({**mix, "steps": 2, "batch": 1}))
    (root / "portbench" / "limits" / "new.cell.json").write_text(
        json.dumps(harness.load_json(ROOT, "portbench", "limits", f"{GEN_CELLS[0]}.json")))
    (root / "portbench" / "metrics" / "new_metric.py").write_text("def read(ctx):\n    return 1.0 + ctx['clips']\n")
    bench["configs"].append({"name": "new-config", "source": "x", "file": "portbench/configs/new-config.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new.cell", "config": "new-config", "traffic": "new-mix", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "new_metric", "unit": "x", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["new.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    tin = tiny.config_overrides(cfg)
    res = harness.run_cell(str(root), "new.cell", SEED, 0.1, 0, "cpu",
                           overrides={"config": tin, "traffic": {**tiny.MIXES["closed_batches"], "batch": 1}})
    assert set(res["metrics"]) == {"new_metric", "setup_s"}
    assert res["metrics"]["new_metric"]["value"] == 1.0 + res["attempted"]
    for p, data in before.items():
        assert open(os.path.join(root, "portbench", p), "rb").read() == data, p


def _files(top):
    out = []
    for d, _, names in os.walk(top):
        out += [os.path.relpath(os.path.join(d, n), top) for n in names if not n.endswith(".pyc")]
    return out


@pytest.mark.parametrize("cell,kind", [(GEN_CELLS[0], "fp8"), (GEN_CELLS[1], "bf16")])
def test_generation_control_fails_the_comparison(cell, kind):
    """The reference a precision below the configuration's, in the
    program's place, reads above the cell's limit."""
    got = control.readings(ROOT, cell, SEED, kind, device="cpu", overrides=overrides(cell))
    ok, checks = compare.verdict(got, limits(cell))
    assert not ok, checks


def test_training_control_and_half_batch_fail_the_comparison():
    for kind, fault in (("fp8", None), ("fp32", "half_batch")):
        got = control.readings(ROOT, TRAIN_CELL, SEED, kind, fault=fault, device="cpu", overrides=overrides(TRAIN_CELL))
        ok, checks = compare.verdict(got, limits(TRAIN_CELL))
        assert not ok, (kind, fault, checks)


def test_an_altered_answer_fails_the_generation_cell(monkeypatch):
    """Clips altered where they are produced (the vocoder's waveforms
    negated) make the run incorrect."""
    from audioldm_tpu_torch.pipeline import generate as gen

    vocode = gen.vocode
    monkeypatch.setattr(gen, "vocode", lambda *args, **kwargs: -vocode(*args, **kwargs))
    res = run(GEN_CELLS[0])
    assert res["correct"] is False, res["checks"]


def test_an_unchanged_state_fails_the_training_cell(monkeypatch):
    """A step that leaves the adapters and the optimizer's moments as they
    were makes the run incorrect."""
    from audioldm_tpu_torch.train import trainer

    monkeypatch.setattr(trainer.LoRAOptimizer, "update",
                        lambda self, count: trainer.clip_by_global_norm_(self.params, self.max_grad_norm))
    res = run(TRAIN_CELL)
    assert res["correct"] is False
    assert res["checks"]["change_leaf_gap"]["value"] == pytest.approx(1.0)
    assert res["checks"]["last_change_leaf_gap"]["value"] == pytest.approx(1.0)


def test_an_optimizer_that_stops_in_the_window_fails_the_training_cell(monkeypatch):
    """Updates that stop once the set-up steps are done, so that only the
    window's steps leave the state unchanged, make the run incorrect by the
    closing step's numbers."""
    from audioldm_tpu_torch.train import trainer

    update = trainer.LoRAOptimizer.update
    check_steps = harness.load_json(ROOT, "portbench", "traffic", "lora-train-b32.json")["check_steps"]

    def stops(self, count):
        if count < check_steps:
            return update(self, count)
        return trainer.clip_by_global_norm_(self.params, self.max_grad_norm)

    monkeypatch.setattr(trainer.LoRAOptimizer, "update", stops)
    res = run(TRAIN_CELL)
    assert res["correct"] is False
    assert res["checks"]["change_leaf_gap"]["value"] <= res["checks"]["change_leaf_gap"]["limit"]
    assert res["checks"]["last_change_leaf_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_fails_the_training_cell(monkeypatch):
    """The loss taken over half of each batch makes the run incorrect."""
    from audioldm_tpu_torch.train import trainer

    loss_fn = trainer.lora_loss_fn

    def half(lora, modules, batch, *args, **kwargs):
        b = batch["log_mel_spec"].shape[0] // 2
        return loss_fn(lora, modules, {k: v[:b] for k, v in batch.items()}, *args, **kwargs)

    monkeypatch.setattr(trainer, "lora_loss_fn", half)
    res = run(TRAIN_CELL)
    assert res["correct"] is False, res["checks"]


def test_check_clips_cover_both_halves_and_the_last_row():
    from portbench.traffic import closed_batches

    for seed in (SEED, 1, 2, 3):
        picks = closed_batches.sample(seed, 9, 16, 4)
        rows = [r for _, r in picks]
        assert rows[-1] == 15 and min(rows) < 8 and len(set(rows)) == 4
        assert all(0 <= i < 9 for i, _ in picks)
    assert closed_batches.sample(SEED, 9, 16, 4) == closed_batches.sample(SEED, 9, 16, 4)


def test_counts_equal_the_programs():
    from audioldm_tpu_torch.utils import flops as pf
    from portbench.counts import flops

    cfg = harness.load_json(ROOT, "portbench", "configs", "audioldm-s-full-v2.bf16.json")
    g = flops.groups(cfg)
    for b in (1, 16):
        ours = flops.pipeline_flops(g["unet"], g["vae"], g["vocoder"], g["text_encoder"], steps=50, batch=b)
        theirs = pf.pipeline_flops(batch=b)
        assert {k: v.useful for k, v in ours.items()} == {k: v.useful for k, v in theirs.items()}
        ours = flops.train_step_flops(g["unet"], g["vae"], g["text_encoder"], batch=b)
        theirs = pf.train_step_flops(batch=b)
        assert {k: v.useful for k, v in ours.items()} == {k: v.useful for k, v in theirs.items()}


@pytest.mark.parametrize("kernel,dtype,shape,bound_ms", [
    # PERF.md's kernel table, column "bound ms"
    ("K1", "bfloat16", (2, 8, 4096, 16), 0.0642), ("K1", "bfloat16", (8, 8, 4096, 16), 0.257),
    ("K1", "bfloat16", (4, 8, 4096, 16), 0.128), ("K1", "float32", (2, 8, 4096, 16), 0.104),
    ("K1", "float32", (8, 8, 4096, 16), 0.416), ("K3", "bfloat16", (2, 8, 4096, 16), 0.0642),
    ("K3", "float32", (2, 8, 4096, 16), 0.104), ("K4", "bfloat16", (2, 8, 4096, 16), 0.0642),
    ("K4", "float32", (2, 8, 4096, 16), 0.208), ("K5", "float32", (2, 8, 4096, 16), 0.156),
    ("K6", "float32", (2, 8, 2048, 16), 0.026), ("K1", "bfloat16", (2, 8, 4000, 16), 0.0612),
])
def test_flash_bounds_equal_the_kernel_table(kernel, dtype, shape, bound_ms):
    from portbench.counts import kernels

    assert kernels.flash_bound_s(kernel, dtype, shape) * 1e3 == pytest.approx(bound_ms, rel=5e-3, abs=5e-4)


@pytest.mark.parametrize("shape,post_k,bound_ms", [
    ((1, 64, 81936), 0, 0.513), ((1, 32, 163872), 7, 0.257), ((4, 64, 81936), 0, 2.050), ((4, 32, 163872), 7, 1.027),
])
def test_mrf_bounds_equal_the_kernel_table(shape, post_k, bound_ms):
    from portbench.counts import kernels

    assert kernels.mrf_bound_s(shape, post_k) * 1e3 == pytest.approx(bound_ms, rel=5e-3)


def test_trace_reduction_attributes_kernels_and_checks_records():
    """A synthetic Chrome trace: kernels go to the ``pb.`` range open at
    their launch; a group whose records fall short of its launches is
    unchecked; idle gaps are named by the host range open when they began."""
    from portbench import trace

    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "pb.unet", "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv", "ts": 10, "dur": 20, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "dur": 2, "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 40, "dur": 2, "tid": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "user_annotation", "name": "pb.decode", "ts": 200, "dur": 50, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 210, "dur": 2, "tid": 1, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "flash_fwd_sm90_kernel<16>", "ts": 20, "dur": 30, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "sm90_gemm", "ts": 60, "dur": 10, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "mrf_stage_kernel<64>", "ts": 220, "dur": 20, "args": {"correlation": 3}},
    ]
    launches = {"K1": {("bfloat16", (2, 8, 4096, 16)): 1}, "K2": {((1, 64, 81936), 0): 2}}
    red = trace.reduce(ev, launches)
    assert red["ranges"]["unet"] == {"count": 1, "device_s": 40e-6, "records": 2}
    assert red["ranges"]["decode"]["records"] == 1
    assert red["groups"]["flash_fwd"]["checked"] and not red["groups"]["mrf"]["checked"]
    assert red["busy_s"] == pytest.approx(60e-6) and red["window_s"] == pytest.approx(250e-6)
    assert red["breakdown"]["idle_gaps"][0][0] == "pb.decode" or red["breakdown"]["idle_gaps"][0][1] > 0
    assert red["breakdown"]["device_ops"][0] == ["flash_fwd_sm90_kernel<16>", 30e-6]


def test_kernels_that_share_a_symbol_are_checked_together():
    """K1, K3 and K6 launch one forward symbol: their records are checked
    against the counters' sum, and the roofline sums their bounds."""
    from portbench import trace
    from portbench.counts import kernels
    from portbench.readings import roofline

    shape = ("bfloat16", (2, 8, 4096, 16))
    ev = [{"ph": "X", "cat": "kernel", "name": f"flash_fwd_sm90_kernel<16, {one}, false>", "ts": 10 * i, "dur": 5,
           "args": {"correlation": i}} for i, one in enumerate(("false", "true", "true"))]
    red = trace.reduce(ev, {"K1": {shape: 1}, "K6": {shape: 2}})
    g = red["groups"]["flash_fwd"]
    assert g["checked"] and g["records"] == g["launches"] == 3
    assert g["bound_s"] == pytest.approx(kernels.flash_bound_s("K1", *shape) + 2 * kernels.flash_bound_s("K6", *shape))
    assert roofline({"trace": red}, "flash_fwd") == pytest.approx(100 * g["bound_s"] / 15e-6)
    assert not trace.reduce(ev, {"K1": {shape: 1}})["groups"]["flash_fwd"]["checked"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell,kind", [(GEN_CELLS[0], "fp8"), (GEN_CELLS[1], "bf16"), (TRAIN_CELL, "fp8")])
def test_control_fails_at_the_cells_size_on_the_card(cell, kind):
    """The controls on the card at the cell's own size (``control.py``
    prints the same numbers for the readings in PERF.md)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's size")
    got = control.readings(ROOT, cell, SEED, kind)
    ok, checks = compare.verdict(got, harness.load_json(ROOT, "portbench", "limits", f"{cell}.json"))
    assert not ok, checks
