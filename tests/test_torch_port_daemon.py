"""The port's online serving daemon (audioldm_tpu_torch/serve/daemon.py):
microbatching by size, deadline and parameters, seeded requests, the HTTP
surface and adapter hot-load, case for case with tests/test_daemon.py, at
the tiny geometry of tests/test_serve.py (2 steps, 0.01 s), fp32 on the CPU.

Two cases show where the port departs from the JAX package on purpose:
``GenParams.validate`` takes the pipeline's own window checks, where
audioldm_tpu/serve/daemon.py:113 accepts an overlap up to 1.0 and :119
compares seconds instead of latent frames.
"""

import base64
import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from audioldm_tpu_torch.ckpt import write_safetensors
from audioldm_tpu_torch.lora import export_peft_state_dict
from audioldm_tpu_torch.pipeline import generate as pg
from audioldm_tpu_torch.serve import AdapterBank, GenParams, Microbatcher, ServeEngine, make_server
from test_torch_port_serve import LCFG, port_adapter, tiny_modules
from tests.test_serve import DummyTokenizer

PARAMS = GenParams(num_inference_steps=2, audio_length_in_s=0.01, guidance_scale=2.0)
DIRECT = dict(num_inference_steps=2, audio_length_in_s=0.01, guidance_scale=2.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: at these tiny sizes a pool of threads only waits
    for its members, and slows by orders of magnitude when test processes
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_engine(with_bank=True, bucket_sizes=(1, 2, 4)):
    mods = tiny_modules()
    bank = AdapterBank.from_adapters({"hiphop": port_adapter(mods.unet, 1)}, LCFG, device="cpu") if with_bank else None
    return ServeEngine(mods, DummyTokenizer(), LCFG, bank=bank, dtype=torch.float32, bucket_sizes=bucket_sizes,
                       device="cpu")


@pytest.fixture(scope="module")
def engine():
    return _make_engine()


def test_batch_forms_on_max_batch(engine):
    """Three concurrent unseeded requests with a long window are one batch
    once max_batch=3 fills, each row the direct engine call under the
    batcher's batch-0 key."""
    mb = Microbatcher(engine, max_batch=3, max_delay_ms=10_000.0, base_seed=7)
    try:
        prompts = ["hip hop beat", "smooth jazz", "rain sounds"]
        futs = [mb.submit(p, params=PARAMS) for p in prompts]
        wavs = np.stack([f.result(timeout=120) for f in futs])
        assert mb.batch_sizes == [3]
        assert mb._batch_rng(0) == (7, 0)  # a folded key, not the unfolded (7,) of a request seeded 7
        direct = engine.generate(prompts, adapters=[None] * 3, rng_key=mb._batch_rng(0), **DIRECT)
        np.testing.assert_allclose(wavs, direct, atol=1e-6)
    finally:
        mb.close()


def test_deadline_closes_underfull_batch(engine):
    mb = Microbatcher(engine, max_batch=8, max_delay_ms=30.0)
    try:
        assert mb.submit("hip hop beat", params=PARAMS).result(timeout=120).shape == (160,)
        assert mb.batch_sizes == [1]
    finally:
        mb.close()


def test_param_groups_never_share_a_batch(engine):
    other = GenParams(num_inference_steps=3, audio_length_in_s=0.01, guidance_scale=2.0)
    mb = Microbatcher(engine, max_batch=2, max_delay_ms=500.0)
    try:
        futs = [mb.submit("hip hop beat", params=PARAMS), mb.submit("jazz", params=PARAMS), mb.submit("rain", params=other)]
        for f in futs:
            f.result(timeout=120)
        assert sorted(mb.batch_sizes) == [1, 2]
    finally:
        mb.close()


def test_seeded_request_batches_and_reproduces(engine):
    """A seeded request shares its batch with an unseeded one and still
    equals ``generate(seed=s)`` at batch 1."""
    mb = Microbatcher(engine, max_batch=2, max_delay_ms=10_000.0, base_seed=7)
    try:
        f_seeded = mb.submit("hip hop beat", params=PARAMS, seed=123)
        f_plain = mb.submit("smooth jazz", params=PARAMS)
        wav = f_seeded.result(timeout=120)
        assert f_plain.result(timeout=120).shape == (160,)
        assert mb.batch_sizes == [2]
        tok, unc = DummyTokenizer()(["hip hop beat"]), DummyTokenizer()([""])
        solo = pg.generate(engine.modules, tok["input_ids"], tok["attention_mask"], unc["input_ids"],
                           unc["attention_mask"], seed=123, dtype=torch.float32, device="cpu", **DIRECT)
        np.testing.assert_allclose(wav, solo[0].numpy(), atol=1e-6)
    finally:
        mb.close()


def test_seeded_lcm_is_solo(engine):
    lcm = GenParams(num_inference_steps=2, audio_length_in_s=0.01, guidance_scale=2.0, scheduler="lcm")
    mb = Microbatcher(engine, max_batch=2, max_delay_ms=10_000.0, base_seed=7)
    try:
        f_seeded = mb.submit("hip hop beat", params=lcm, seed=123)
        f_plain = mb.submit("smooth jazz", params=lcm)
        wav = f_seeded.result(timeout=180)
        mb.close()  # serves the unseeded one
        assert f_plain.result(timeout=120).shape == (160,)
        assert 1 in mb.batch_sizes
        solo = engine.generate(["hip hop beat"], seed=123, scheduler="lcm", **DIRECT)
        np.testing.assert_array_equal(wav, solo[0])
    finally:
        mb.close()


def test_unknown_adapter_fails_fast(engine):
    mb = Microbatcher(engine, max_batch=2, max_delay_ms=20.0)
    try:
        with pytest.raises(KeyError, match="unknown adapter"):
            mb.submit("beat", adapter="nope", params=PARAMS)
    finally:
        mb.close()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=180) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def _delete(url):
    req = urllib.request.Request(url, method="DELETE")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _pcm(resp):
    with wave.open(io.BytesIO(base64.b64decode(resp["audio_b64"]))) as w:
        assert w.getframerate() == 16000
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float32) / 32767.0


class _Server:
    """A daemon on 127.0.0.1 at a free port, in a thread; ``stop`` ends it."""

    def __init__(self, mb, **kw):
        self.mb, self.srv = mb, make_server(mb, sample_rate=16000, port=0, **kw)
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.srv.server_address[1]}"

    def stop(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.mb.close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


@pytest.fixture()
def server(engine):
    s = _Server(Microbatcher(engine, max_batch=2, max_delay_ms=30.0))
    yield s.base, s.mb
    s.stop()


def test_http_generate_and_health(server, engine):
    base, mb = server
    assert _get(base + "/healthz") == (200, {"ok": True})
    code, resp = _post(base + "/v1/generate", {"prompt": "hip hop beat", "steps": 2, "seconds": 0.01,
                                               "guidance": 2.0, "seed": 5})
    assert code == 200 and resp["sample_rate"] == 16000 and resp["samples"] == 160
    direct = engine.generate(["hip hop beat"], seed=5, **DIRECT)
    np.testing.assert_allclose(_pcm(resp), np.clip(direct[0], -1, 1), atol=1.0 / 32767.0)
    code, stats = _get(base + "/v1/stats")
    assert code == 200 and stats["served"] >= 1
    code, resp = _post(base + "/v1/generate", {"steps": 2})
    assert code == 400 and "prompt" in resp["error"]
    code, resp = _post(base + "/v1/generate", {"prompt": "x", "adapter": "nope", "steps": 2, "seconds": 0.01})
    assert code == 400 and "unknown adapter" in resp["error"]


def test_http_concurrent_requests_batch(server):
    base, mb = server
    results = {}

    def call(i):
        results[i] = _post(base + "/v1/generate", {"prompt": f"beat {i}", "steps": 2, "seconds": 0.01, "guidance": 2.0})

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    before = len(mb.batch_sizes)
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads)
    assert all(results[i][0] == 200 for i in range(2))
    assert sum(mb.batch_sizes[before:]) == 2


def test_hot_load_adapter_http(tmp_path):
    """POST /v1/adapters loads a PEFT safetensors written by the port into a
    bank-less running engine; generations with it differ from base."""
    engine = _make_engine(with_bank=False)
    path = str(tmp_path / "model.safetensors")
    write_safetensors(path, export_peft_state_dict(port_adapter(engine.modules.unet, 9, shift=0.08)))
    s = _Server(Microbatcher(engine, max_batch=1, max_delay_ms=10.0))
    try:
        code, _ = _post(s.base + "/v1/generate", {"prompt": "x", "adapter": "funk", "steps": 2, "seconds": 0.01})
        assert code == 400  # not loaded yet
        code, resp = _post(s.base + "/v1/adapters", {"name": "funk", "path": path})
        assert code == 200 and resp == {"loaded": "funk", "rank": 2, "adapters": ["base", "funk"]}
        gen = {"prompt": "hip hop beat", "steps": 2, "seconds": 0.01, "guidance": 2.0, "seed": 3}
        code, with_lora = _post(s.base + "/v1/generate", {**gen, "adapter": "funk"})
        assert code == 200
        code, plain = _post(s.base + "/v1/generate", gen)
        assert code == 200 and with_lora["audio_b64"] != plain["audio_b64"]
        code, _ = _post(s.base + "/v1/adapters", {"name": "x", "path": str(tmp_path / "nope.safetensors")})
        assert code == 400
    finally:
        s.stop()


def test_load_adapter_replace_invalidates_merged_cache(engine):
    mb = Microbatcher(engine, max_batch=1, max_delay_ms=10.0)
    try:
        w1 = mb.submit("hip hop beat", adapter="hiphop", params=PARAMS, seed=1).result(timeout=120)
        assert "hiphop" in engine._merged_cache
        new = port_adapter(engine.modules.unet, 42, shift=0.2)
        mb.load_adapter("hiphop", new, rank=2)
        assert "hiphop" not in engine._merged_cache
        w2 = mb.submit("hip hop beat", adapter="hiphop", params=PARAMS, seed=1).result(timeout=120)
        assert np.max(np.abs(w1 - w2)) > 1e-6
        with pytest.raises(ValueError, match="rank"):
            mb.load_adapter("other", new, rank=4)
    finally:
        mb.close()


def test_http_compose_adapter_and_generate(server):
    base, mb = server
    code, resp = _post(base + "/v1/adapters", {"name": "blend", "compose": {"hiphop": 0.6}})
    assert code == 200 and resp["composed"] == "blend" and "blend" in resp["composed_all"]
    code, listing = _get(base + "/v1/adapters")
    assert code == 200 and "blend" in listing["composed"]
    code, resp = _post(base + "/v1/generate", {"prompt": "hip hop beat", "adapter": "blend", "steps": 2,
                                               "seconds": 0.01, "guidance": 2.0, "seed": 3})
    assert code == 200, resp
    direct = mb.engine.generate(["hip hop beat"], adapters=["blend"], seed=3, **DIRECT)
    np.testing.assert_allclose(_pcm(resp), np.clip(direct[0], -1, 1), atol=1.0 / 32767.0)
    code, resp = _post(base + "/v1/adapters", {"name": "bad", "compose": {"ghost": 1.0}})
    assert code == 400 and "cannot compose" in resp["error"]
    code, _ = _post(base + "/v1/adapters", {"name": "bad"})
    assert code == 400


def test_http_negative_prompt_isolation(server):
    base, mb = server
    body = {"prompt": "hip hop beat", "steps": 2, "seconds": 0.01, "guidance": 2.0, "seed": 11}
    _, r_default = _post(base + "/v1/generate", body)
    _, r_neg = _post(base + "/v1/generate", {**body, "negative_prompt": "low quality"})
    assert r_default["audio_b64"] != r_neg["audio_b64"]
    n0 = len(mb.batch_sizes)
    futs = [mb.submit("beat", params=GenParams(2, 0.01, 2.0, "ddim", None)),
            mb.submit("beat", params=GenParams(2, 0.01, 2.0, "ddim", "noisy"))]
    for f in futs:
        f.result(timeout=120)
    assert len(mb.batch_sizes) == n0 + 2


def test_stats_latency_percentiles(engine):
    mb = Microbatcher(engine, max_batch=2, max_delay_ms=10.0)
    try:
        assert mb.stats()["latency_ms"] is None
        mb.submit("beat", params=PARAMS).result(timeout=120)
        s = mb.stats()
        assert s["latency_ms"]["p50"] > 0 and s["latency_ms"]["p99"] >= s["latency_ms"]["p50"]
    finally:
        mb.close()


def test_component_reload_refreshes_compositions():
    eng = _make_engine()
    mb = Microbatcher(eng, max_batch=2, max_delay_ms=20.0)
    try:
        eng.add_composed("blend", {"hiphop": 1.0})
        out1 = mb.submit("beat", adapter="blend", params=PARAMS, seed=9).result(timeout=180)
        new = port_adapter(eng.modules.unet, 7, shift=-0.03)
        mb.load_adapter("hiphop", new, rank=2, alpha=4)
        out2 = mb.submit("beat", adapter="blend", params=PARAMS, seed=9).result(timeout=180)
        assert np.max(np.abs(out1 - out2)) > 1e-7
        direct = eng.generate(["beat"], adapters=["hiphop"], seed=9, **DIRECT)
        np.testing.assert_allclose(out2, direct[0], atol=1e-6)
        with pytest.raises(ValueError, match="taken by a composed"):
            mb.load_adapter("blend", new, rank=2, alpha=4)
    finally:
        mb.close()


def test_unservable_combination_fails_solo_not_batch():
    eng = _make_engine(bucket_sizes=(2,))  # one bucket: mixed batches take the rank-r route
    eng.add_composed("blend", {"hiphop": 1.0})
    mb = Microbatcher(eng, max_batch=2, max_delay_ms=10_000.0)
    try:
        f1, f2 = mb.submit("a", adapter="blend", params=PARAMS), mb.submit("b", adapter="base", params=PARAMS)
        assert f1.result(timeout=180).shape == (160,) and f2.result(timeout=180).shape == (160,)
        assert mb.batch_sizes == [1, 1]
    finally:
        mb.close()


def test_http_delete_adapter():
    s = _Server(Microbatcher(_make_engine(), max_batch=1, max_delay_ms=10.0))
    try:
        assert _post(s.base + "/v1/adapters", {"name": "mix", "compose": {"hiphop": 1.0}})[0] == 200
        code, resp = _delete(s.base + "/v1/adapters/hiphop")
        assert code == 409 and "component" in resp["error"]
        code, resp = _delete(s.base + "/v1/adapters/mix")
        assert code == 200 and resp["removed"] == "mix"
        code, resp = _delete(s.base + "/v1/adapters/hiphop")
        assert code == 200 and resp["adapters"] == ["base"]
        code, _ = _post(s.base + "/v1/generate", {"prompt": "x", "adapter": "hiphop", "steps": 2, "seconds": 0.01})
        assert code == 400  # gone: it fails fast, never runs on base weights
        assert _delete(s.base + "/v1/adapters/hiphop")[0] == 404
        assert _delete(s.base + "/v1/adapters/")[0] == 404
    finally:
        s.stop()


def test_lru_eviction_at_max_adapters():
    eng = _make_engine()  # starts with 'hiphop'
    mk = lambda seed: port_adapter(eng.modules.unet, seed)
    mb = Microbatcher(eng, max_batch=1, max_delay_ms=10.0, max_adapters=2)
    try:
        mb.load_adapter("jazz", mk(2), 2)
        assert sorted(eng.bank.names) == ["base", "hiphop", "jazz"]
        mb.load_adapter("funk", mk(3), 2)  # hiphop was never served or loaded here: least recent
        assert sorted(eng.bank.names) == ["base", "funk", "jazz"]
        mb.load_adapter("jazz", mk(4), 2)  # replacing never evicts
        assert sorted(eng.bank.names) == ["base", "funk", "jazz"]
        mb.compose_adapter("mix", {"jazz": 0.5, "funk": 0.5})
        with pytest.raises(ValueError, match="composition component"):
            mb.load_adapter("rock", mk(5), 2)
    finally:
        mb.close()


def test_http_guidance_interval(server, engine):
    base, _ = server
    code, resp = _post(base + "/v1/generate", {"prompt": "hip hop beat", "steps": 2, "seconds": 0.01, "guidance": 2.0,
                                               "seed": 5, "guidance_interval": [0.0, 0.3]})
    assert code == 200
    direct = engine.generate(["hip hop beat"], seed=5, guidance_interval=(0.0, 0.3), **DIRECT)
    np.testing.assert_allclose(_pcm(resp), np.clip(direct[0], -1, 1), atol=1.0 / 32767.0)
    for gi in ([0.9, 0.1], "bad", "01", [0.1, 0.5, 0.9]):
        code, resp = _post(base + "/v1/generate", {"prompt": "x", "steps": 2, "seconds": 0.01, "guidance_interval": gi})
        assert code == 400 and "guidance_interval" in resp["error"], gi


def test_inflight_adapter_pinned_against_eviction_and_delete():
    eng = _make_engine()
    a2 = port_adapter(eng.modules.unet, 5, shift=0.02)
    mb = Microbatcher(eng, max_batch=8, max_delay_ms=10_000.0, max_adapters=1)
    try:
        fut = mb.submit("beat", adapter="hiphop", params=PARAMS)
        with pytest.raises(ValueError, match="in-flight"):
            mb.remove_adapter("hiphop")
        with pytest.raises(ValueError, match="pinned"):
            mb.load_adapter("funk", a2, rank=2, alpha=4)
        assert eng.has_adapter("hiphop")
        mb.close()  # serves the queue: the pinned request runs
        assert fut.result(timeout=180).shape == (160,)
        mb.load_adapter("funk", a2, rank=2, alpha=4)  # pin lifted: hiphop is evicted
        assert eng.has_adapter("funk") and not eng.has_adapter("hiphop")
    finally:
        mb.close()


def test_batch_keys_leave_the_seeded_family(engine):
    """The unseeded rows of the first batches draw no latents that a request
    seeded with a small int draws (``key_generator``'s folded family)."""
    mb = Microbatcher(engine, max_batch=1, max_delay_ms=1.0, base_seed=0)
    try:
        draw = lambda g: tuple(torch.randn(6, generator=g).tolist())
        seeded = {draw(pg.row_generator(k, 0)) for k in range(256)}
        for ordinal in range(16):
            key = mb._batch_rng(ordinal)
            assert all(draw(pg.key_generator(key, row)) not in seeded for row in range(4))
    finally:
        mb.close()


def test_geometry_allowlist(engine):
    mb = Microbatcher(engine, max_batch=2, max_delay_ms=30.0, geometries=[PARAMS])
    try:
        assert mb.submit("hip hop beat", params=PARAMS).result(timeout=120).shape == (160,)
        neg = dataclasses.replace(PARAMS, negative_prompt="noise")
        assert mb.submit("beat", params=neg).result(timeout=120).shape == (160,)
        dangling = dataclasses.replace(PARAMS, window_overlap=0.9)
        assert mb.submit("beat", params=dangling).result(timeout=120).shape == (160,)
        for bad in (dataclasses.replace(PARAMS, num_inference_steps=3), dataclasses.replace(PARAMS, audio_length_in_s=30.0),
                    dataclasses.replace(PARAMS, scheduler="dpm++"), dataclasses.replace(PARAMS, window_seconds=5.0),
                    dataclasses.replace(PARAMS, guidance_interval=(0.1, 0.5))):
            with pytest.raises(ValueError, match="allowlist"):
                mb.submit("beat", params=bad)
    finally:
        mb.close()


def test_geometry_allowlist_mixed_optional_fields():
    class _NoEngine:  # submit checks the geometry before the engine
        bank = None
        composed = {}

        def has_adapter(self, name):
            return True

    mb = Microbatcher(_NoEngine(), max_batch=2, geometries=[
        PARAMS, dataclasses.replace(PARAMS, guidance_interval=(0.05, 0.65)),
        dataclasses.replace(PARAMS, window_seconds=0.005, window_overlap=0.25)])
    try:
        with pytest.raises(ValueError, match="allowlist"):
            mb.submit("beat", params=dataclasses.replace(PARAMS, num_inference_steps=7))
    finally:
        mb.close()


def test_http_geometry_allowlist(engine):
    s = _Server(Microbatcher(engine, max_batch=2, max_delay_ms=30.0, geometries=[PARAMS]))
    try:
        assert _post(s.base + "/v1/generate", {"prompt": "hip hop beat", "steps": 2, "seconds": 0.01, "guidance": 2.0})[0] == 200
        for body in ({"prompt": "hip hop beat", "steps": 50, "seconds": 120.0},
                     {"prompt": "hip hop beat", "steps": 2, "seconds": 0.01, "guidance": 2.0, "scheduler": "dpm++"}):
            code, resp = _post(s.base + "/v1/generate", body)
            assert code == 400 and "allowlist" in resp["error"]
    finally:
        s.stop()


def test_http_bad_typed_fields_400(server):
    base, _ = server
    for body in ({"prompt": "x", "steps": "fast"}, {"prompt": "x", "seconds": [10]}, {"prompt": "x", "guidance": "high"},
                 {"prompt": "x", "window_overlap": "half"}, {"prompt": "x", "seed": "abc"}):
        code, resp = _post(base + "/v1/generate", body)
        assert code == 400 and "bad parameter" in resp["error"], body


def test_http_defaults_fill_from_server(engine):
    s = _Server(Microbatcher(engine, max_batch=2, max_delay_ms=30.0, geometries=[PARAMS], defaults=PARAMS))
    try:
        code, resp = _post(s.base + "/v1/generate", {"prompt": "hip hop beat"})
        assert code == 200 and resp["samples"] == 160
        assert _post(s.base + "/v1/generate", {"prompt": "hip hop beat", "steps": None, "seconds": None})[0] == 200
        code, resp = _post(s.base + "/v1/generate", {"prompt": "x", "steps": 3})
        assert code == 400 and "allowlist" in resp["error"]
    finally:
        s.stop()


def test_geometry_allowlist_raw_tuple_normalized(engine):
    mb = Microbatcher(engine, max_batch=2, max_delay_ms=30.0, geometries=[(2, 0.01, 2.0, "ddim", None, 0.5, None)])
    try:
        assert mb.submit("hip hop beat", params=PARAMS).result(timeout=120).shape == (160,)
    finally:
        mb.close()
    with pytest.raises(ValueError, match="fields"):
        Microbatcher(engine, max_batch=2, geometries=[(2, 0.01, 2.0)])


def test_http_non_dict_body_400(server):
    base, _ = server
    for body in (5, None, "a prompt", [1, 2]):
        code, resp = _post(base + "/v1/generate", body)
        assert code == 400 and "JSON object" in resp["error"], body
        assert _post(base + "/v1/adapters", body)[0] == 400


def test_http_invalid_param_combos_400(server):
    base, _ = server
    for body, frag in (
        ({"prompt": "x", "scheduler": "fast"}, "scheduler"),
        ({"prompt": "x", "steps": 0}, "steps"),
        ({"prompt": "x", "seconds": 0}, "seconds"),
        ({"prompt": "x", "steps": 2, "seconds": 0.01, "scheduler": "lcm", "guidance_interval": [0.1, 0.5]}, "lcm"),
        ({"prompt": "x", "steps": 2, "seconds": 0.01, "window_seconds": 0.005, "guidance_interval": [0.1, 0.5]}, "windowed"),
        ({"prompt": "x", "steps": 2, "seconds": 0.01, "window_seconds": 0.005, "window_overlap": 1.5}, "window_overlap"),
    ):
        code, resp = _post(base + "/v1/generate", body)
        assert code == 400 and frag in resp["error"], (body, resp)


def test_genparams_validate_mirrors_pipeline_rules(engine):
    mods = engine.modules
    GenParams(num_inference_steps=2, audio_length_in_s=0.01, guidance_interval=(0.1, 0.5)).validate(mods)
    GenParams(num_inference_steps=2, audio_length_in_s=0.01, window_seconds=0.02, guidance_interval=(0.1, 0.5)).validate(mods)
    with pytest.raises(ValueError, match="windowed"):
        GenParams(num_inference_steps=2, audio_length_in_s=0.01, window_seconds=0.005,
                  guidance_interval=(0.1, 0.5)).validate(mods)
    with pytest.raises(ValueError, match="scheduler"):
        GenParams(scheduler="euler").validate(mods)


def test_validate_bounds_the_overlap_as_the_pipeline_does(server, engine):
    """An overlap in (0.9, 1) is a 400, as ``window_params`` rejects it; the
    JAX package's check (audioldm_tpu/serve/daemon.py:113) lets it through
    to fail in the batch thread as a 500. 0.9 itself serves."""
    base, _ = server
    body = {"prompt": "x", "steps": 2, "seconds": 0.01, "guidance": 2.0, "window_seconds": 0.005}
    code, resp = _post(base + "/v1/generate", {**body, "window_overlap": 0.95})
    assert code == 400 and "window_overlap" in resp["error"]
    with pytest.raises(ValueError, match="window_overlap"):  # the pipeline's own bound
        pg.window_params(engine.modules, 0.005, 0.95)
    code, resp = _post(base + "/v1/generate", {**body, "window_overlap": 0.9})
    assert code == 200 and resp["samples"] == 160


def test_validate_compares_latent_frames_not_seconds(server, engine):
    """Whether a window windows is ``denoise``'s rule, in latent frames: at
    0.01 s (20 latent frames) a 0.0099 s window is 20 frames, the standard
    path, so guidance_interval serves (the JAX check at
    audioldm_tpu/serve/daemon.py:119 compares seconds and answers 400);
    at 0.01025 s (21 frames) a window of the same 0.01025 s rounds to 20
    frames and does window, so it is a 400 (JAX accepts it, and the
    pipeline then raises in the batch thread)."""
    base, _ = server
    mods = engine.modules
    assert pg.window_params(mods, 0.0099, 0.5)[0] == pg.latent_shape(mods, 1, 0.01)[2] == 20
    assert pg.window_params(mods, 0.01025, 0.5)[0] == 20 < pg.latent_shape(mods, 1, 0.01025)[2] == 21
    gi = {"prompt": "x", "steps": 2, "guidance": 2.0, "guidance_interval": [0.0, 0.3], "seed": 4}
    code, resp = _post(base + "/v1/generate", {**gi, "seconds": 0.01, "window_seconds": 0.0099})
    assert code == 200 and resp["samples"] == 160
    code, resp = _post(base + "/v1/generate", {**gi, "seconds": 0.01025, "window_seconds": 0.01025})
    assert code == 400 and "windowed" in resp["error"]


def test_geometry_allowlist_entry_type_coercion(engine):
    mb = Microbatcher(engine, max_batch=2, max_delay_ms=30.0, geometries=[("2", "0.01", 2.0, "ddim", None, None, [0.05, 0.65])])
    try:
        assert (2, 0.01, 2.0, "ddim", None, None, (0.05, 0.65)) in mb.geometries
    finally:
        mb.close()
    with pytest.raises(ValueError, match="bad geometry entry"):
        Microbatcher(engine, max_batch=2, geometries=[(object(), 0.01, 2.0, "ddim", None, None, None)])
    with pytest.raises(ValueError, match="lo, hi"):
        Microbatcher(engine, max_batch=2, geometries=[(2, 0.01, 2.0, "ddim", None, None, [0.1, 0.5, 0.9])])


def test_http_request_timeout_504(engine):
    s = _Server(Microbatcher(engine, max_batch=2, max_delay_ms=30.0), request_timeout_s=0.001)
    try:
        code, resp = _post(s.base + "/v1/generate", {"prompt": "x", "steps": 2, "seconds": 0.01})
        assert code == 504 and "did not complete" in resp["error"], (code, resp)
    finally:
        s.stop()
