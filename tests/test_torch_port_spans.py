"""The port's span recorder (audioldm_tpu_torch/utils/profiling.py) and the
spans at its layer boundaries: off by default and free, nested per thread
when on, bounded, on the profiler's clock; the serving engine's and the
trainer's span trees at tiny widths on the CPU; outputs bit-equal with
spans on and off; the batcher's queue wait."""

from __future__ import annotations

import json
import threading
import time
import tracemalloc
from collections import Counter

import numpy as np
import pytest
import torch

from audioldm_tpu_torch import config as tcfg
from audioldm_tpu_torch.lora import init_lora
from audioldm_tpu_torch.pipeline import generate as pg
from audioldm_tpu_torch.serve import GenParams, Microbatcher, ServeEngine
from audioldm_tpu_torch.train import trainer as port_trainer
from audioldm_tpu_torch.utils import profiling

UNET = tcfg.UNetConfig(in_channels=4, out_channels=4, block_out_channels=(8, 16),
                       down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                       up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1, norm_num_groups=4,
                       attention_head_dim=2, projection_class_embeddings_input_dim=8)
VAE = tcfg.VAEConfig(in_channels=1, out_channels=1, block_out_channels=(8, 16), layers_per_block=1, latent_channels=4,
                     norm_num_groups=4, scaling_factor=0.9)
TEXT = tcfg.ClapTextConfig(vocab_size=64, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                           intermediate_size=32, max_position_embeddings=40, projection_dim=8)
VOC = tcfg.VocoderConfig(model_in_dim=8, upsample_initial_channel=16, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                         resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),), sampling_rate=16000)
LCFG = tcfg.LoRAConfig(r=2, lora_alpha=4.0)
STEPS = 3
UNET_BLOCKS = ["unet.in", "unet.down.0", "unet.down.1", "unet.mid", "unet.up.0", "unet.up.1", "unet.out"]


class Tokenizer:
    def __call__(self, texts):
        ids = np.ones((len(texts), 6), np.int64)
        for i, t in enumerate(texts):
            ids[i, : 2 + len(t.split())] = [0] + [5 + len(w) for w in t.split()] + [2]
        return {"input_ids": ids, "attention_mask": (ids != 1).astype(np.int64)}


@pytest.fixture(autouse=True)
def _spans_off():
    """Every test starts and ends with spans off and nothing recorded."""
    profiling.disable()
    profiling.drain()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    profiling.disable()
    profiling.drain()


def _modules() -> pg.AudioLDMModules:
    return pg.random_modules(0, UNET, VAE, TEXT, VOC, device="cpu")


def _tree(spans: list) -> tuple[dict, dict]:
    """``(span by id, children's names by parent id)``."""
    by_id = {s["id"]: s for s in spans}
    kids: dict = {}
    for s in sorted(spans, key=lambda s: s["start_ns"]):
        kids.setdefault(s["parent"], []).append(s["name"])
    return by_id, kids


def _spin(us: float) -> None:
    end = time.perf_counter() + us / 1e6
    while time.perf_counter() < end:
        pass


def test_off_hands_out_one_shared_noop_and_records_nothing():
    assert not profiling.enabled()
    assert profiling.span("a") is profiling.span("b", key=3, bucket=4)
    with profiling.span("gen.step") as s:
        assert s is profiling.span("c")
    profiling.count("c")
    profiling.record("serve.queue", 0, 1)
    tracemalloc.start()
    try:
        with profiling.span("warm"):
            pass
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(2000):
            with profiling.span("gen.step"):
                pass
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 512, grown  # nothing kept per span
    assert profiling.drain() == {"spans": [], "counters": {}, "dropped": 0}


def test_on_nests_per_thread_inherits_the_key_and_counts():
    profiling.enable()

    @profiling.spanned("decorated", kind="fn")
    def work():
        with profiling.span("leaf"):
            pass

    with profiling.span("root", key=7) as root:
        work()
        profiling.count("hits", 2)
        profiling.count("hits")
    t = threading.Thread(target=lambda: profiling.span("other").__enter__().__exit__(None, None, None))
    t.start()
    t.join(10)
    assert not t.is_alive()
    profiling.disable()
    with profiling.span("after_off"):
        pass
    taken = profiling.drain()
    spans = {s["name"]: s for s in taken["spans"]}
    assert set(spans) == {"root", "decorated", "leaf", "other"}
    assert spans["root"]["parent"] is None and spans["root"]["id"] == root.id
    assert spans["decorated"]["parent"] == root.id and spans["leaf"]["parent"] == spans["decorated"]["id"]
    assert spans["decorated"]["attrs"] == {"kind": "fn"}
    assert {spans[n]["key"] for n in ("root", "decorated", "leaf")} == {7}
    assert spans["other"]["parent"] is None and spans["other"]["key"] is None  # another thread, its own stack
    assert spans["other"]["thread"] != spans["root"]["thread"] == threading.get_native_id()
    for s in spans.values():
        assert s["start_ns"] <= s["end_ns"]
    assert spans["root"]["start_ns"] <= spans["leaf"]["start_ns"] <= spans["leaf"]["end_ns"] <= spans["root"]["end_ns"]
    assert taken["counters"] == {"hits": 3} and taken["dropped"] == 0
    assert profiling.drain()["spans"] == []


def test_the_buffer_is_bounded_and_counts_what_it_dropped():
    profiling.enable(capacity=3)
    for i in range(5):
        with profiling.span(f"s{i}"):
            pass
    profiling.record("queued", 10, 20, key=1)
    taken = profiling.drain()
    assert [s["name"] for s in taken["spans"]] == ["s0", "s1", "s2"] and taken["dropped"] == 3
    with profiling.span("again"):  # drained: room again
        pass
    assert [s["name"] for s in profiling.drain()["spans"]] == ["again"]


def test_spans_share_the_profilers_clock(tmp_path):
    """A span around a ``record_function`` holds the profiler's event after
    conversion, and a ``record_function`` around a span holds the span:
    the two clocks agree to better than the 0.2 ms margins."""
    from torch.profiler import ProfilerActivity, profile, record_function

    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer_span"):
            _spin(200)
            with record_function("inner_range"):
                _spin(50)
            _spin(200)
        with record_function("outer_range"):
            _spin(200)
            with profiling.span("inner_span"):
                _spin(50)
            _spin(200)
    profiling.disable()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    trace = json.loads((tmp_path / "t.json").read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    ranges = {e["name"]: e for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    spans = {e["name"]: e for e in profiling.trace_events(profiling.drain(), base)}

    def inside(a, b):  # a within b, both Chrome events
        return b["ts"] <= a["ts"] and a["ts"] + a["dur"] <= b["ts"] + b["dur"]

    assert inside(ranges["inner_range"], spans["outer_span"]), (ranges["inner_range"], spans["outer_span"])
    assert inside(spans["inner_span"], ranges["outer_range"]), (spans["inner_span"], ranges["outer_range"])


def test_engine_generate_gives_the_span_tree_and_one_key():
    engine = ServeEngine(_modules(), Tokenizer(), LCFG, dtype=torch.float32, bucket_sizes=(1, 2, 4), device="cpu")
    run = dict(num_inference_steps=STEPS, audio_length_in_s=0.01, guidance_scale=2.0, seed=5)
    off = engine.generate(["a drum loop", "rain"], **run)
    profiling.enable()
    on = engine.generate(["a drum loop", "rain"], **run)
    profiling.disable()
    np.testing.assert_array_equal(on, off)  # spans change no output
    taken = profiling.drain()
    by_id, kids = _tree(taken["spans"])
    (root,) = [s for s in taken["spans"] if s["parent"] is None]
    assert root["name"] == "engine.generate" and root["attrs"] == {"rows": 2}
    assert kids[root["id"]] == ["engine.prepare", "gen.prepare", "gen.text", "gen.noise", "gen.denoise", "gen.decode",
                                "gen.vocode", "engine.copy_out"]
    assert {s["key"] for s in taken["spans"]} == {root["key"]} and root["key"] is not None
    (prep,) = [s for s in taken["spans"] if s["name"] == "engine.prepare"]
    assert prep["attrs"] == {"route": "base", "bucket": 2}
    (den,) = [s for s in taken["spans"] if s["name"] == "gen.denoise"]
    assert kids[den["id"]] == ["gen.step"] * STEPS
    for step in (s for s in taken["spans"] if s["name"] == "gen.step"):
        assert kids[step["id"]] == UNET_BLOCKS  # one CFG-folded UNet call a step
    assert taken["counters"] == {} and not engine.counters  # the base route hits no cache and gathers nothing


def test_trainer_fit_gives_the_train_tree_and_equal_updates(tmp_path):
    mods = _modules()
    train_cfg = tcfg.TrainConfig(learning_rate=1e-3, max_train_steps=10, checkpointing_steps=100)
    trainer = port_trainer.Trainer(mods, LCFG, train_cfg, str(tmp_path), device="cpu")
    gen = torch.Generator().manual_seed(3)
    batch = {"log_mel_spec": torch.randn(2, 1, 16, 8, generator=gen), "input_ids": np.array([[0, 9, 2, 1]] * 2),
             "attention_mask": np.array([[1, 1, 1, 0]] * 2)}

    def fresh():
        lora = init_lora(mods.unet, LCFG, torch.Generator().manual_seed(1))
        with torch.no_grad():
            for p in lora.b.values():
                p.copy_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(2)))
        return trainer.init_state(lora)

    def fit(state):
        return trainer.fit(state, iter([batch, batch]), generator=torch.Generator().manual_seed(4), max_steps=2)

    off, m_off = fit(fresh())
    profiling.enable()
    on, m_on = fit(fresh())
    profiling.disable()
    assert torch.equal(m_on["loss"], m_off["loss"])
    for (_, a0, b0), (_, a1, b1) in zip(off.lora.items(), on.lora.items()):
        assert torch.equal(a0, a1) and torch.equal(b0, b1)
    taken = profiling.drain()
    by_id, kids = _tree(taken["spans"])
    (root,) = [s for s in taken["spans"] if s["parent"] is None]
    assert root["name"] == "train.fit"
    assert kids[root["id"]] == ["train.preamble", "train.fetch", "train.step", "train.fetch", "train.step"]
    steps = [s for s in taken["spans"] if s["name"] == "train.step"]
    assert [s["key"] for s in steps] == [1, 2]
    for step in steps:
        assert kids[step["id"]] == ["train.encode", "train.noise", "train.text", "train.loss", "train.backward",
                                    "train.optim"]
        (loss,) = [s for s in taken["spans"] if s["name"] == "train.loss" and s["parent"] == step["id"]]
        assert kids[loss["id"]] == UNET_BLOCKS
        assert all(s["key"] == step["key"] for s in taken["spans"] if s["parent"] in (step["id"], loss["id"]))


class _SlowEngine:
    """A stand-in engine whose every batch takes ``hold`` seconds."""

    bank, composed = None, {}

    def __init__(self, hold: float):
        self.hold, self.times = hold, []
        self.counters = Counter(merged_hits=2, bank_gathers=1)

    def has_adapter(self, name):
        return name in (None, "base")

    def check_adapters(self, adapters):
        pass

    def generate(self, prompts, **kwargs):
        t0 = time.monotonic()
        time.sleep(self.hold)
        self.times.append(time.monotonic() - t0)
        return np.zeros((len(prompts), 4), np.float32)


def test_a_request_behind_a_full_batch_waits_at_least_the_batchs_time():
    engine = _SlowEngine(0.15)
    mb = Microbatcher(engine, max_batch=1, max_delay_ms=0.0)
    profiling.enable()
    try:
        assert mb.stats()["queue_wait_ms"] is None
        with mb._cv:  # both queued before the scheduler takes the first
            first = mb.submit("a", params=GenParams())
            second = mb.submit("b", params=GenParams())
        first.result(timeout=30), second.result(timeout=30)
    finally:
        mb.close()
        profiling.disable()
    assert mb.batch_sizes == [1, 1]
    waits = list(mb.queue_waits_ms)
    assert waits[1] >= 1e3 * engine.times[0], (waits, engine.times)
    stats = mb.stats()
    assert stats["queue_wait_ms"]["p99"] >= 1e3 * engine.times[0] * 0.99
    assert stats["latency_ms"]["p50"] > 0
    assert stats["engine"] == {"merged_hits": 2, "merged_misses": 0, "bank_gathers": 1}
    spans = profiling.drain()["spans"]
    queued = {s["key"]: s for s in spans if s["name"] == "serve.queue"}
    assert sorted(queued) == [1, 2]
    assert (queued[2]["end_ns"] - queued[2]["start_ns"]) / 1e6 == pytest.approx(waits[1], abs=0.01)
    assert [s["attrs"]["requests"] for s in spans if s["name"] == "serve.batch"] == [[1], [2]]
