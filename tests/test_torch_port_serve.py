"""The port's multi-LoRA serving (audioldm_tpu_torch/serve/engine.py, the
per-row and densified adapter forms of models/nn.py, ``denoise(lora=)``,
``ckpt.bank_from_jax`` and ``cli serve``) at the tiny geometry of
tests/test_serve.py (``TINY_*``, 2 steps, 0.01 s), fp32 on the CPU.

Against the JAX package at 1e-4: ``denoise`` with a gathered bank (rank-r,
hybrid, dense, and with limited-interval guidance), the bank's gathers and
the merged cache's UNet, on the same weights and bank carried across. The
engine draws its latents from the port's generators, which JAX cannot
reproduce, so the engine itself is held against the port's own
``generate``, case for case with tests/test_serve.py. Where a JAX test
reads the engine's ``traces``, these read ``ServeEngine.batches`` and the
padded batches that reach the UNet.
"""

import dataclasses
import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioldm_tpu.config import DDIMConfig
from audioldm_tpu.config import LoRAConfig as JaxLoRAConfig
from audioldm_tpu.lora import init_lora as jax_init_lora
from audioldm_tpu.lora import merge_lora as jax_merge_lora
from audioldm_tpu.models.clap_text import init_clap_text
from audioldm_tpu.models.unet import init_unet
from audioldm_tpu.models.vae import init_vae
from audioldm_tpu.models.vocoder import init_vocoder
from audioldm_tpu.pipeline.generate import AudioLDMModules as JaxModules
from audioldm_tpu.pipeline.generate import denoise as jax_denoise
from audioldm_tpu.serve import AdapterBank as JaxAdapterBank
from audioldm_tpu.serve import ServeEngine as JaxServeEngine
from audioldm_tpu_torch import cli
from audioldm_tpu_torch import config as tcfg
from audioldm_tpu_torch.ckpt import bank_from_jax, from_jax_params, lora_from_jax, read_safetensors, write_safetensors
from audioldm_tpu_torch.lora import compose_adapters, export_peft_state_dict, import_peft_state_dict, init_lora, merge_lora
from audioldm_tpu_torch.models.unet import UNet2DConditionModel
from audioldm_tpu_torch.pipeline import audio2audio as a2a
from audioldm_tpu_torch.pipeline import generate as pg
from audioldm_tpu_torch.serve import AdapterBank, ServeEngine
from test_torch_port_pipeline import SECONDS as CKPT_SECONDS
from test_torch_port_models import numpy_params
from test_torch_port_pipeline import checkpoint, jax_modules  # noqa: F401 (fixtures)
from tests.test_pipeline import TINY_TEXT, TINY_UNET, TINY_VAE, TINY_VOC
from tests.test_serve import DummyTokenizer

GEN = dict(num_inference_steps=2, audio_length_in_s=0.01, guidance_scale=2.0, seed=0)
NOSEED = {k: v for k, v in GEN.items() if k != "seed"}
LCFG = tcfg.LoRAConfig(r=2, lora_alpha=4.0)
JLCFG = JaxLoRAConfig(r=2, lora_alpha=4)
NAMES = ("hiphop", "jazz", "funk")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: at these tiny sizes a pool of threads only waits
    for its members, and slows by orders of magnitude when test processes
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_modules() -> pg.AudioLDMModules:
    """Port modules at the tiny geometry, random weights (seed 0)."""
    cfgs = [t(**dataclasses.asdict(j)) for t, j in ((tcfg.UNetConfig, TINY_UNET), (tcfg.VAEConfig, TINY_VAE),
                                                     (tcfg.ClapTextConfig, TINY_TEXT), (tcfg.VocoderConfig, TINY_VOC))]
    return pg.random_modules(0, *cfgs, device="cpu")


def port_adapter(unet, seed: int, shift: float = 0.05):
    """A port adapter with nonzero B: init_lora plus seeded N(0, shift) noise."""
    gen = torch.Generator().manual_seed(seed)
    lora = init_lora(unet, LCFG, gen)
    with torch.no_grad():
        for p in lora.parameters():
            p.add_(shift * torch.randn(p.shape, generator=gen))
    return lora


@pytest.fixture(scope="module")
def world():
    """JAX modules and a bank of three adapters (numpy draws from seeds), and
    the port's, carried across."""
    jm = JaxModules(
        unet=numpy_params(init_unet, TINY_UNET, 10), vae=numpy_params(init_vae, TINY_VAE, 11),
        text_encoder=numpy_params(init_clap_text, TINY_TEXT, 12), vocoder=numpy_params(init_vocoder, TINY_VOC, 13),
        unet_cfg=TINY_UNET, vae_cfg=TINY_VAE, text_cfg=TINY_TEXT, vocoder_cfg=TINY_VOC, ddim_cfg=DDIMConfig(),
    )
    rng = np.random.default_rng(5)
    shapes = jax.eval_shape(lambda k: jax_init_lora(k, jm.unet, JLCFG), jax.ShapeDtypeStruct((2,), jnp.uint32))
    adapters = {name: jax.tree.map(lambda x: (0.3 * rng.standard_normal(x.shape)).astype(np.float32), shapes)
                for name in NAMES}
    jbank = JaxAdapterBank.from_adapters(adapters, JLCFG)
    mods = tiny_modules()
    for name, sd in from_jax_params(unet=jm.unet, vae=jm.vae, text_encoder=jm.text_encoder, vocoder=jm.vocoder).items():
        getattr(mods, name).load_state_dict(sd, strict=True)
    bank = bank_from_jax(jax.device_get(jbank.stacked), jbank.names, 2, device="cpu")
    return jm, jbank, mods, bank


@pytest.fixture(scope="module")
def engine(world):
    _, _, mods, bank = world
    return ServeEngine(mods, DummyTokenizer(), LCFG, bank=bank, dtype=torch.float32, device="cpu")


def make(engine, **kw) -> ServeEngine:
    """Another engine over ``engine``'s modules and bank."""
    kw = dict(dtype=torch.float32, device="cpu") | kw
    return ServeEngine(engine.modules, DummyTokenizer(), engine.lora_cfg, bank=kw.pop("bank", engine.bank), **kw)


def _jax_flat(tree, prefix=""):
    """``{dotted path: entry dict}`` of a JAX adapter tree (leaves a/b or ab)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if "a" in v or "ab" in v:
            out[key] = v
        else:
            out.update(_jax_flat(v, key))
    return out


def _gathers(jbank, bank, names, kind):
    """The JAX and port gathers of ``names`` (cfg batch 2) by ``kind``:
    "rank_r", "hybrid" (projections of width <= 8 densified) or "dense"."""
    jidx, idx = jbank.indices(list(names)), bank.indices(list(names))
    if kind == "rank_r":
        return jbank.gather(jidx, cfg_batch=2), bank.gather(idx, 2)
    dim = 8 if kind == "hybrid" else None
    return (jbank.gather_dense(jidx, cfg_batch=2, dtype=jnp.float32, max_dense_dim=dim),
            bank.gather_dense(idx, 2, torch.float32, dim))


# -- against the JAX package ---------------------------------------------------


@pytest.mark.parametrize("kind", ["rank_r", "hybrid", "dense"])
def test_bank_gathers_match_jax(world, kind):
    """``gather``/``gather_dense`` of a batch with three adapters and "base",
    leaf for leaf (hybrid: the 8-wide level densified, the 16-wide kept)."""
    _, jbank, _, bank = world
    jl, pl = _gathers(jbank, bank, NAMES + ("base",), kind)
    flat = _jax_flat(jl)
    assert sorted(flat) == sorted(pl) and len(pl) == 16  # to_q, to_v of 8 attentions
    forms = set()
    for path, entry in pl.items():
        if isinstance(entry, torch.Tensor):
            forms.add("ab")
            np.testing.assert_allclose(entry.numpy(), np.asarray(flat[path]["ab"]), atol=1e-6)
        else:
            forms.add("a")
            for x, key in zip(entry, ("a", "b")):
                assert x.shape[0] == 8  # 4 requests, tiled over the CFG halves
                np.testing.assert_array_equal(x.numpy(), np.asarray(flat[path][key]))
    assert forms == {"rank_r": {"a"}, "hybrid": {"a", "ab"}, "dense": {"ab"}}[kind]


@pytest.mark.parametrize("kind,interval", [("rank_r", None), ("hybrid", None), ("dense", None), ("rank_r", (0.0, 0.3))])
def test_denoise_with_bank_rows_matches_jax(world, kind, interval):
    """The port's ``denoise`` with a gathered per-row tree (three adapters
    and "base" in one batch) against JAX ``denoise`` on the same latents,
    embeddings and bank, 1e-4; with the interval (0, 0.3) the second of the
    two steps (t = 1) is guided and the first (t = 501) runs the
    conditional-only UNet on the first B rows of every entry."""
    jm, jbank, mods, bank = world
    rng = np.random.default_rng(11)
    lat = rng.standard_normal(pg.latent_shape(mods, 4, 0.01)).astype(np.float32)
    cond, uncond = (rng.standard_normal((4, 8)).astype(np.float32) for _ in range(2))
    jl, pl = _gathers(jbank, bank, NAMES + ("base",), kind)
    ref = jax_denoise(jm, jnp.asarray(lat.transpose(0, 2, 3, 1)), jnp.asarray(cond), jnp.asarray(uncond), 2, 2.0,
                      lora=jl, lora_scale=JLCFG.scale, dtype=jnp.float32, guidance_interval=interval)
    args = (mods, torch.from_numpy(lat), torch.from_numpy(cond), torch.from_numpy(uncond), 2, 2.0, torch.float32)
    out = pg.denoise(*args, lora=pl, lora_scale=LCFG.scale, guidance_interval=interval).numpy()
    np.testing.assert_allclose(out, np.asarray(ref).transpose(0, 3, 1, 2), atol=1e-4)
    base = pg.denoise(*args, guidance_interval=interval).numpy()
    assert np.abs(out[:3] - base[:3]).max() > 1e-3  # the adapters are felt
    np.testing.assert_allclose(out[3], base[3], atol=1e-6)  # the "base" row is the zero adapter


def test_bank_from_jax_slot_for_slot(world):
    _, jbank, _, bank = world
    assert bank.names == jbank.names and bank.capacity == jbank.capacity and bank.rank == 2
    flat = _jax_flat(jax.device_get(jbank.stacked))
    assert sorted(flat) == sorted(bank.a)
    for path, entry in flat.items():
        np.testing.assert_array_equal(bank.a[path].numpy(), entry["a"])
        np.testing.assert_array_equal(bank.b[path].numpy(), entry["b"])
    fresh = bank_from_jax(jax.device_get(jbank.stacked), jbank.names, 2, device="cpu")
    assert fresh.add("new", bank.adapter("jazz")) == jbank._next == 4  # the slot JAX's next add takes


def test_merged_cache_unet_matches_jax_merge(world, engine):
    """The merged cache's UNet against JAX ``merge_lora`` of the same slot,
    1e-4; the shared base UNet stays as it was (the port merges in place,
    so the cache must merge into a copy)."""
    jm, jbank, mods, _ = world
    before = {k: v.clone() for k, v in mods.unet.state_dict().items()}
    merged = engine.merged_modules("jazz").unet.state_dict()
    slot = jax.tree.map(lambda x: x[jbank.names["jazz"]], jbank.stacked)
    want = from_jax_params(unet=jax_merge_lora(jm.unet, slot, JLCFG))["unet"]
    assert sorted(merged) == sorted(want)
    moved = 0
    for k, v in want.items():
        np.testing.assert_allclose(merged[k].numpy(), v.numpy(), atol=1e-4)
        moved += not torch.equal(merged[k], before[k])
    assert moved == 16  # to_q and to_v of the 8 attentions
    for k, v in mods.unet.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert engine.merged_modules("jazz").vae is mods.vae  # only the UNet is copied


def test_split_gate_routes_as_jax(world, engine):
    """The split cost gate routes the batches of tests/test_serve.py:357 and
    :395 as the JAX engine does: fine buckets split a mixed batch into
    merged sub-batches, buckets of 4 alone keep the rank-r route. The JAX
    engine's programs are replaced by a recorder of their keys (nothing is
    compiled), the port's routes read from ``batches``."""
    jm, jbank, _, _ = world
    batch = (["hip hop beat", "smooth jazz", "boom bap", "plain"], ["hiphop", "jazz", "hiphop", None])
    for buckets in ((1, 2, 4, 8, 16), (1, 2, 4), (4,)):
        jeng = JaxServeEngine(jm, DummyTokenizer(), JLCFG, bank=jbank, dtype=jnp.float32, bucket_sizes=buckets)
        seen = []
        jeng._fn = lambda key, *a, **k: (lambda *args, _k=key: seen.append(_k[:2]) or jnp.zeros((_k[1], 160)))
        jeng._merged_cache = {n: jm for n in NAMES}  # no merge needed by a recorder
        jeng.generate(*batch, **GEN)
        eng = make(engine, bucket_sizes=buckets)
        eng.generate(*batch, **GEN)
        port = sorted(("lora" if route == "rank_r" else "plain", b) for (route, b), n in eng.batches.items() for _ in range(n))
        assert port == sorted(seen), buckets
    assert seen == [("lora", 4)]  # (4,): rank-r kept
    assert set(eng.batches) == {("rank_r", 4)}


# -- the engine against the port's own generate (tests/test_serve.py) --------


def test_bank_slots(engine):
    assert engine.bank.names == {"base": 0, "hiphop": 1, "jazz": 2, "funk": 3}
    assert engine.bank.indices(["jazz", "base"]).tolist() == [2, 0]


def test_per_request_adapter_isolation(engine):
    """A mixed batch splits into per-adapter sub-batches: each row equals a
    uniform call of its group with the group-folded key (groups in sorted
    name order); adapters change the output and differ from each other."""
    prompts = ["hip hop beat", "hip hop beat"]
    mixed = engine.generate(prompts, adapters=["hiphop", "base"], **GEN)
    assert mixed.shape == (2, 160)
    base_row = engine.generate([prompts[1]], adapters=["base"], rng_key=(0, 0), **NOSEED)
    hip_row = engine.generate([prompts[0]], adapters=["hiphop"], rng_key=(0, 1), **NOSEED)
    np.testing.assert_allclose(mixed[1], base_row[0], atol=1e-6)
    np.testing.assert_allclose(mixed[0], hip_row[0], atol=1e-6)
    base_same_key = engine.generate([prompts[0]], adapters=["base"], rng_key=(0, 1), **NOSEED)
    assert np.max(np.abs(hip_row[0] - base_same_key[0])) > 1e-6
    jazz = engine.generate([prompts[0]], adapters=["jazz"], rng_key=(0, 1), **NOSEED)
    assert np.max(np.abs(jazz[0] - hip_row[0])) > 1e-6


def test_base_slot_is_zero_adapter(engine):
    """A "base" row, on every route, is plain generation."""
    tok, unc = DummyTokenizer()(["hip hop beat"]), DummyTokenizer()([""])
    plain = pg.generate(engine.modules, tok["input_ids"], tok["attention_mask"], unc["input_ids"], unc["attention_mask"],
                        dtype=torch.float32, device="cpu", **GEN).numpy()
    np.testing.assert_allclose(engine.generate(["hip hop beat"], adapters=["base"], **GEN), plain, atol=1e-6)
    np.testing.assert_allclose(engine.generate(["hip hop beat"], **GEN), plain, atol=1e-6)
    rank_r = make(engine, bucket_sizes=(2,)).generate(["hip hop beat", "x"], adapters=["base", "jazz"], **GEN)
    np.testing.assert_allclose(rank_r[:1], plain, atol=1e-5)


def test_merged_cache_matches_generate_on_merged_modules(engine):
    prompts = ["hip hop beat", "hip hop beat"]
    via_bank = engine.generate(prompts, adapters=["jazz", "jazz"], **GEN)
    tok, unc = DummyTokenizer()(prompts), DummyTokenizer()([""])
    wav = pg.generate(engine.merged_modules("jazz"), tok["input_ids"], tok["attention_mask"], unc["input_ids"],
                      unc["attention_mask"], dtype=torch.float32, device="cpu", **GEN)
    np.testing.assert_allclose(via_bank, wav.numpy(), atol=1e-6)


def test_seeded_rows_are_batch_independent(engine):
    """A seeded row draws ``row_generator(seed, 0)``: in a mixed batch it
    equals the solo seeded call and ``generate(seed=s)`` at batch 1."""
    solo = engine.generate(["hip hop beat"], seed=123, **NOSEED)
    tok, unc = DummyTokenizer()(["hip hop beat"]), DummyTokenizer()([""])
    direct = pg.generate(engine.modules, tok["input_ids"], tok["attention_mask"], unc["input_ids"], unc["attention_mask"],
                         seed=123, dtype=torch.float32, device="cpu", **NOSEED).numpy()
    np.testing.assert_array_equal(solo, direct)
    prompts = ["smooth jazz", "hip hop beat", "lo-fi rain", "drum solo"]
    mixed = engine.generate(prompts, seeds=[None, 123, None, None], seed=7, **NOSEED)
    np.testing.assert_allclose(mixed[1], solo[0], atol=1e-6)
    solo5 = engine.generate(["lo-fi rain"], seed=5, **NOSEED)
    both = engine.generate(prompts, seeds=[None, 123, 5, None], seed=9, **NOSEED)
    np.testing.assert_allclose(both[1], solo[0], atol=1e-6)
    np.testing.assert_allclose(both[2], solo5[0], atol=1e-6)
    assert not np.array_equal(mixed[0], both[0])  # unseeded rows follow the batch key


def test_seeded_rows_survive_mixed_adapter_split(engine):
    solo = engine.generate(["hip hop beat"], adapters=["jazz"], seed=77, **NOSEED)
    mixed = engine.generate(["a beat", "hip hop beat", "quiet piano"], adapters=["base", "jazz", "hiphop"],
                            seeds=[None, 77, None], seed=3, **NOSEED)
    np.testing.assert_allclose(mixed[1], solo[0], atol=1e-6)


def test_submit_flush_microbatching(engine):
    assert [engine.submit("hip hop beat", a) for a in ("hiphop", None, "jazz")] == [0, 1, 2]
    wavs = engine.flush(max_batch=2, **GEN)
    assert wavs.shape == (3, 160) and np.all(np.isfinite(wavs))
    assert engine.flush().size == 0  # queue drained


@pytest.fixture()
def unet_batches(monkeypatch):
    """The batch sizes of every UNet call (merged copies included)."""
    seen = []
    forward = UNet2DConditionModel.forward
    monkeypatch.setattr(UNet2DConditionModel, "forward", lambda self, x, *a, **k: seen.append(x.shape[0]) or forward(self, x, *a, **k))
    return seen


def test_flush_pads_to_buckets(engine, unet_batches):
    """Queues of 4 and 3 requests reach the UNet as the same padded batch
    (bucket 4, CFG-folded to 8); a mixed flush without grouping splits into
    two merged sub-batches of bucket 2."""
    eng = make(engine)
    for _ in range(4):
        eng.submit("hip hop beat", "hiphop")
    out1 = eng.flush(**GEN)
    for _ in range(3):
        eng.submit("boom bap", "hiphop")
    out2 = eng.flush(**GEN)
    assert out1.shape == (4, 160) and out2.shape == (3, 160)
    assert unet_batches == [8] * 4 and eng.batches == {("merged", 4): 2}
    for p, a in (("boom bap", "jazz"), ("boom bap", "jazz"), ("hip hop", "hiphop"), ("hip hop", "hiphop")):
        eng.submit(p, a)
    assert eng.flush(group_by_adapter=False, **GEN).shape == (4, 160)
    assert unet_batches[4:] == [4] * 4 and eng.batches[("merged", 2)] == 2


def test_flush_keys_never_collide(engine):
    engine.submit("hip hop beat", "hiphop")
    a = engine.flush(**GEN)
    engine.submit("hip hop beat", "hiphop")
    b = engine.flush(**GEN)
    assert np.max(np.abs(a - b)) > 1e-6


def test_adapters_without_bank_raise(engine):
    eng = make(engine, bank=None)
    with pytest.raises(ValueError, match="no AdapterBank"):
        eng.generate(["x"], adapters=["jazz"], **GEN)
    assert eng.generate(["x"], adapters=["base"], **GEN).shape == (1, 160)


def test_oversized_batch_chunks_to_max_bucket(engine):
    eng = make(engine, bucket_sizes=(2,))
    out = eng.generate(["hip hop beat", "boom bap", "smooth jazz", "hip hop beat", "last one"], adapters=["hiphop"] * 5, **GEN)
    assert out.shape == (5, 160)
    assert eng.batches == {("merged", 2): 3}


def test_underfilled_bucket_keeps_merged_route(engine):
    eng = make(engine)
    out = eng.generate(["hip hop beat", "boom bap", "hip hop beat"], adapters=["hiphop"] * 3, **GEN)
    assert out.shape == (3, 160) and "hiphop" in eng._merged_cache and eng.batches == {("merged", 4): 1}
    full = eng.generate(["hip hop beat", "boom bap", "hip hop beat", "x"], adapters=["hiphop"] * 4, **GEN)
    np.testing.assert_allclose(out, full[:3], atol=1e-6)


@pytest.mark.parametrize("dim", [8, 16])
def test_hybrid_dense_serving_matches_rank_r(engine, dim):
    prompts, adapters = ["hip hop beat", "smooth jazz"], ["hiphop", "jazz"]
    a = make(engine, bucket_sizes=(2,)).generate(prompts, adapters=adapters, **GEN)
    b = make(engine, bucket_sizes=(2,), dense_lora_max_dim=dim).generate(prompts, adapters=adapters, **GEN)
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_merged_route_equals_rank_r_route(engine):
    """Rows 0 and 1 draw the same latents in both batches (per-row
    generators), so the merged route and the rank-r route agree, 1e-4."""
    eng = make(engine)
    uniform = eng.generate(["hip hop beat", "boom bap"], adapters=["hiphop", "hiphop"], **GEN)
    assert set(eng.batches) == {("merged", 2)}
    nosplit = make(engine, bucket_sizes=(4,))
    mixed = nosplit.generate(["hip hop beat", "boom bap", "filler"], adapters=["hiphop", "hiphop", "base"], **GEN)
    assert set(nosplit.batches) == {("rank_r", 4)}
    np.testing.assert_allclose(uniform, mixed[:2], atol=1e-4)


def test_flush_groups_by_adapter_and_restores_order(engine):
    engine._rng_counter = 0
    prompts, adapters = ["hip hop beat", "jazz piano", "boom bap", "smooth sax"], ["hiphop", "jazz", "hiphop", "jazz"]
    for p, a in zip(prompts, adapters):
        engine.submit(p, a)
    out = engine.flush(max_batch=2, seed=7, **NOSEED)
    assert out.shape == (4, 160)
    c1 = engine.generate(["hip hop beat", "boom bap"], adapters=["hiphop"] * 2, rng_key=(7, 1), **NOSEED)
    c2 = engine.generate(["jazz piano", "smooth sax"], adapters=["jazz"] * 2, rng_key=(7, 2), **NOSEED)
    np.testing.assert_array_equal(out[[0, 2]], c1)  # each chunk as it would run alone, launched before any copy
    np.testing.assert_array_equal(out[[1, 3]], c2)


def test_generate_pads_to_bucket_and_slices(engine):
    assert engine.generate(["hip hop beat"], adapters=["hiphop"], **GEN).shape == (1, 160)
    assert engine.generate(["a", "b", "c"], adapters=["jazz"] * 3, **GEN).shape == (3, 160)


def test_mixed_batch_splits_to_merged_subbatches(engine):
    eng = make(engine)
    prompts, adapters = ["hip hop beat", "smooth jazz", "boom bap", "plain"], ["hiphop", "jazz", "hiphop", None]
    out = eng.generate(prompts, adapters=adapters, **GEN)
    assert out.shape == (4, 160)
    assert set(eng._merged_cache) == {"hiphop", "jazz"}
    assert eng.batches == {("base", 1): 1, ("merged", 2): 1, ("merged", 1): 1}  # never rank-r
    base = eng.generate(["plain"], adapters=["base"], rng_key=(0, 0), **NOSEED)
    hip = eng.generate(["hip hop beat", "boom bap"], adapters=["hiphop"] * 2, rng_key=(0, 1), **NOSEED)
    jazz = eng.generate(["smooth jazz"], adapters=["jazz"], rng_key=(0, 2), **NOSEED)
    np.testing.assert_allclose(out[3], base[0], atol=1e-6)
    np.testing.assert_allclose(out[[0, 2]], hip, atol=1e-6)
    np.testing.assert_allclose(out[1], jazz[0], atol=1e-6)


def test_generate_empty_batch(engine):
    out = engine.generate([], **GEN)
    assert out.shape == (0, 0) and out.dtype == np.float32


def test_warmup_runs_every_bucket(engine, unet_batches):
    eng = make(engine, bucket_sizes=(1, 2))
    eng.warmup(num_inference_steps=2, audio_length_in_s=0.01, guidance_scale=2.0)
    assert eng.batches == {("base", 1): 1, ("base", 2): 1}
    assert sorted(set(unet_batches)) == [2, 4]
    wav = eng.generate(["a b", "c d"], adapters=["hiphop"] * 2, **GEN)
    np.testing.assert_array_equal(wav, engine.generate(["a b", "c d"], adapters=["hiphop"] * 2, **GEN))


def test_composed_adapter_serves_from_merged_cache(engine):
    """A composition equals an engine whose base UNet has the composition
    merged by hand, and differs from its components."""
    engine.add_composed("fusion", {"hiphop": 0.7, "jazz": 0.3})
    assert engine.has_adapter("fusion") and not engine.has_adapter("nope")
    out = engine.generate(["hip hop beat"], adapters=["fusion"], **GEN)
    parts = [(engine.bank.adapter(n), LCFG, w) for n, w in (("hiphop", 0.7), ("jazz", 0.3))]
    import copy

    manual = dataclasses.replace(engine.modules, unet=merge_lora(copy.deepcopy(engine.modules.unet), *compose_adapters(parts)))
    ref = ServeEngine(manual, DummyTokenizer(), LCFG, dtype=torch.float32, device="cpu").generate(["hip hop beat"], **GEN)
    np.testing.assert_allclose(out, ref, atol=1e-6)
    hip = engine.generate(["hip hop beat"], adapters=["hiphop"], **GEN)
    assert np.max(np.abs(out - hip)) > 1e-6


def test_composed_in_mixed_batch_rides_split_route(engine):
    engine.add_composed("fusion2", {"hiphop": 0.5, "jazz": 0.5})
    prompts = ["hip hop beat", "smooth jazz"]
    mixed = engine.generate(prompts, adapters=["fusion2", "base"], **GEN)
    base_row = engine.generate([prompts[1]], adapters=["base"], rng_key=(0, 0), **NOSEED)
    fus_row = engine.generate([prompts[0]], adapters=["fusion2"], rng_key=(0, 1), **NOSEED)
    np.testing.assert_allclose(mixed[1], base_row[0], atol=1e-6)
    np.testing.assert_allclose(mixed[0], fus_row[0], atol=1e-6)


def test_composed_rank_r_path_raises(engine):
    eng = make(engine, bucket_sizes=(2,))
    eng.add_composed("mix", {"hiphop": 1.0})
    with pytest.raises(ValueError, match="rank-r"):
        eng.generate(["a", "b"], adapters=["mix", "jazz"], **GEN)


def test_unknown_adapter_fails_fast_with_bank(engine):
    with pytest.raises(ValueError, match="unknown adapter"):
        engine.generate(["x"], adapters=["no-such"], **GEN)


def test_compose_validates_components(engine):
    with pytest.raises(KeyError, match="cannot compose"):
        engine.add_composed("bad", {"hiphop": 0.5, "ghost": 0.5})
    with pytest.raises(KeyError, match="cannot compose"):
        engine.add_composed("bad", {"base": 1.0})


def test_per_request_negative_prompt(engine):
    out_over = engine.generate(["hip hop beat"], negative_prompt="low quality", **GEN)
    ref = make(engine, negative_prompt="low quality").generate(["hip hop beat"], **GEN)
    np.testing.assert_allclose(out_over, ref, atol=1e-6)
    assert np.max(np.abs(out_over - engine.generate(["hip hop beat"], **GEN))) > 1e-7


def test_engine_windowed_generation(engine):
    """A clip-covering window is the standard path, a real one changes the
    output; windows with per-row adapters raise, as in JAX
    (audioldm_tpu/pipeline/generate.py:386-391)."""
    std = engine.generate(["hip hop beat"], **GEN)
    np.testing.assert_array_equal(engine.generate(["hip hop beat"], window_seconds=1.0, **GEN), std)
    win = engine.generate(["hip hop beat"], window_seconds=0.002, **GEN)
    assert win.shape == std.shape and np.max(np.abs(win - std)) > 1e-7
    assert engine.generate(["a", "b"], adapters=["jazz", "base"], window_seconds=0.002, **GEN).shape == (2, 160)
    with pytest.raises(ValueError, match="windowed denoise"):
        make(engine, bucket_sizes=(2,)).generate(["a", "b"], adapters=["jazz", "base"], window_seconds=0.002, **GEN)


def test_composed_name_collision_rejected(engine):
    with pytest.raises(ValueError, match="collides"):
        engine.add_composed("hiphop", {"jazz": 1.0})


def test_refresh_composed_recomputes_from_new_component(engine):
    eng = make(engine, bank=AdapterBank.from_adapters({"x": engine.bank.adapter("hiphop")}, LCFG, device="cpu"))
    eng.add_composed("blend", {"x": 1.0})
    out1 = eng.generate(["beat"], adapters=["blend"], **GEN)
    eng.bank.add("x", engine.bank.adapter("jazz"))  # hot-replace component x
    eng._merged_cache.pop("x", None)
    assert eng.refresh_composed("x") == ["blend"]
    out2 = eng.generate(["beat"], adapters=["blend"], **GEN)
    assert np.max(np.abs(out1 - out2)) > 1e-7
    np.testing.assert_allclose(out2, eng.generate(["beat"], adapters=["x"], **GEN), atol=1e-6)


def test_guidance_interval_serving(engine):
    """An empty interval equals the guidance-1.0 path; (0, 0.3), which
    leaves the high-noise step unguided, differs from standard CFG."""
    from audioldm_tpu_torch.models.scheduler import inference_timesteps

    n = engine.modules.ddim_cfg.num_train_timesteps
    ts = inference_timesteps(engine.modules.ddim_cfg, 2)
    empty = (float(max(ts) + 0.5) / (n - 1), float(max(ts) + 0.6) / (n - 1))
    gi_empty = engine.generate(["hip hop beat"], guidance_interval=empty, **GEN)
    np.testing.assert_array_equal(gi_empty, engine.generate(["hip hop beat"], **(GEN | {"guidance_scale": 1.0})))
    std = engine.generate(["hip hop beat"], **GEN)
    mid = engine.generate(["hip hop beat"], guidance_interval=(0.0, 0.3), **GEN)
    assert np.all(np.isfinite(mid)) and np.max(np.abs(mid - std)) > 1e-7


def test_guidance_interval_on_rank_r_batched_lora(engine):
    """On the rank-r route the per-row entries are CFG-tiled to 2B rows and
    the conditional-only steps take the first B: an empty interval equals
    the guidance-1.0 rank-r run (rows B), a sub-interval differs from CFG."""
    from audioldm_tpu_torch.models.scheduler import inference_timesteps

    nosplit = make(engine, bucket_sizes=(2,))
    prompts, adapters = ["hip hop beat", "smooth jazz"], ["hiphop", "jazz"]
    n = engine.modules.ddim_cfg.num_train_timesteps
    ts = inference_timesteps(engine.modules.ddim_cfg, 2)
    empty = (float(max(ts) + 0.5) / (n - 1), float(max(ts) + 0.6) / (n - 1))
    gi_empty = nosplit.generate(prompts, adapters=adapters, guidance_interval=empty, **GEN)
    cond_only = nosplit.generate(prompts, adapters=adapters, **(GEN | {"guidance_scale": 1.0}))
    np.testing.assert_allclose(gi_empty, cond_only, atol=1e-6)
    mid = nosplit.generate(prompts, adapters=adapters, guidance_interval=(0.0, 0.3), **GEN)
    std = nosplit.generate(prompts, adapters=adapters, **GEN)
    assert np.all(np.isfinite(mid)) and np.max(np.abs(mid - std)) > 1e-7


def test_lcm_on_the_rank_r_route(engine):
    """lcm runs the UNet at batch B (no CFG), so the rank-r route gathers B
    rows for it, not 2B: the "base" row equals a base-only batch of the same
    key and bucket. (The JAX engine tiles 2B rows for lcm too,
    audioldm_tpu/serve/engine.py:698, and its matmul fails on the shapes.)"""
    nosplit = make(engine, bucket_sizes=(2,))
    kw = dict(GEN, scheduler="lcm")
    mixed = nosplit.generate(["a", "b"], adapters=["hiphop", "base"], **kw)
    base = nosplit.generate(["a", "b"], adapters=["base", "base"], **kw)
    assert set(nosplit.batches) == {("rank_r", 2), ("base", 2)}
    np.testing.assert_allclose(mixed[1], base[1], atol=1e-6)
    assert np.abs(mixed[0] - base[0]).max() > 1e-6


def test_flush_launches_every_chunk_before_copying(engine, monkeypatch):
    """``flush`` copies to the host only after the last chunk's launch, and
    its output equals fetching each chunk at once."""
    events = []
    assemble, launch = ServeEngine._assemble, ServeEngine._generate_async
    monkeypatch.setattr(ServeEngine, "_assemble", staticmethod(lambda parts, b: events.append("copy") or assemble(parts, b)))
    monkeypatch.setattr(ServeEngine, "_generate_async", lambda self, *a, **k: events.append("launch") or launch(self, *a, **k))
    engine._rng_counter = 0
    for p, a in zip(["hip hop beat", "jazz piano", "boom bap", "smooth sax"], ["hiphop", "jazz", "hiphop", "jazz"]):
        engine.submit(p, a)
    out = engine.flush(max_batch=2, seed=11, **NOSEED)
    assert events == ["launch", "launch", "copy", "copy"]
    monkeypatch.undo()
    c1 = engine.generate(["hip hop beat", "boom bap"], adapters=["hiphop"] * 2, rng_key=(11, 1), **NOSEED)
    c2 = engine.generate(["jazz piano", "smooth sax"], adapters=["jazz"] * 2, rng_key=(11, 2), **NOSEED)
    np.testing.assert_array_equal(out[[0, 2]], c1)
    np.testing.assert_array_equal(out[[1, 3]], c2)


def test_engine_and_bank_raise_without_a_gpu(engine):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ServeEngine(engine.modules, DummyTokenizer(), LCFG)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        AdapterBank(engine.bank.adapter("jazz"), 2)
    assert engine.modules.device.type == "cpu"


# -- AdapterBank capacity and slots --------------------------------------------


def _toy_adapter(v: float) -> dict:
    return {"q": (torch.full((4, 2), v), torch.full((2, 4), v))}


def test_bank_prealloc_growth_and_slot_reuse():
    bank = AdapterBank(_toy_adapter(0.0), rank=2, capacity=4, device="cpu")
    assert bank.capacity == 4 and len(bank) == 1
    bank.add("x", _toy_adapter(1.0))
    bank.add("y", _toy_adapter(2.0))
    assert bank.capacity == 4 and bank.names == {"base": 0, "x": 1, "y": 2}
    a, b = bank.gather(bank.indices(["y", "base", "x"]))["q"]
    np.testing.assert_array_equal(a[0].numpy(), np.full((4, 2), 2.0))
    np.testing.assert_array_equal(a[1].numpy(), np.zeros((4, 2)))
    np.testing.assert_array_equal(b[2].numpy(), np.full((2, 4), 1.0))
    bank.add("z", _toy_adapter(3.0))
    bank.add("w", _toy_adapter(4.0))  # full -> doubles
    assert bank.capacity == 8
    bank.remove("x")
    assert "x" not in bank.names and bank.a["q"][1].abs().max() == 0  # zeroed: a stale index gathers base
    assert bank.add("r", _toy_adapter(5.0)) == 1  # reused
    assert bank.add("r", _toy_adapter(6.0)) == 1  # replaced in place
    np.testing.assert_array_equal(bank.gather(bank.indices(["r"]))["q"][0][0].numpy(), np.full((4, 2), 6.0))
    with pytest.raises(KeyError, match="unknown adapter"):
        bank.remove("nope")
    with pytest.raises(ValueError, match="base"):
        bank.remove("base")
    with pytest.raises(ValueError, match="reserved"):
        bank.add("base", _toy_adapter(1.0))


def test_bank_slot_write_is_in_place():
    """A hot-load below capacity writes into the preallocated tensors (the
    counterpart of the JAX package's donated slot update)."""
    bank = AdapterBank(_toy_adapter(0.0), rank=2, capacity=4, device="cpu")
    ptr = bank.a["q"].data_ptr()
    bank.add("x", _toy_adapter(1.0))
    bank.remove("x")
    bank.add("y", _toy_adapter(2.0))
    assert bank.a["q"].data_ptr() == ptr


def test_bank_max_capacity_enforced():
    bank = AdapterBank(_toy_adapter(0.0), rank=2, capacity=2, max_capacity=2, device="cpu")
    bank.add("x", _toy_adapter(1.0))
    assert bank.full
    with pytest.raises(ValueError, match="full"):
        bank.add("y", _toy_adapter(2.0))
    bank.add("x", _toy_adapter(3.0))
    bank.remove("x")
    assert not bank.full
    bank.add("y", _toy_adapter(2.0))


def test_engine_remove_adapter_guards():
    mods = tiny_modules()
    bank = AdapterBank.from_adapters({"p": port_adapter(mods.unet, 1), "q": port_adapter(mods.unet, 2)}, LCFG, device="cpu")
    eng = ServeEngine(mods, DummyTokenizer(), LCFG, bank=bank, dtype=torch.float32, device="cpu")
    eng.add_composed("mix", {"p": 0.5, "q": 0.5})
    with pytest.raises(ValueError, match="component"):
        eng.remove_adapter("p")
    eng.remove_adapter("mix")
    assert "mix" not in eng.composed and "mix" not in eng._merged_cache
    eng.remove_adapter("p")
    assert not eng.has_adapter("p") and eng.has_adapter("q")
    with pytest.raises(KeyError, match="unknown adapter"):
        eng.remove_adapter("p")


def test_bank_rejects_bad_adapter_atomically():
    bank = AdapterBank(_toy_adapter(0.0), rank=2, capacity=4, device="cpu")
    bank.add("good", _toy_adapter(1.0))
    with pytest.raises(ValueError, match="bank unchanged"):
        bank.add("bad", {"q": (torch.ones(4, 2), torch.ones(3, 4))})
    with pytest.raises(ValueError, match="bank unchanged"):
        bank.add("bad", {"k": (torch.ones(4, 2), torch.ones(2, 4))})
    assert "bad" not in bank.names
    a, _ = bank.gather(bank.indices(["good", "base"]))["q"]
    np.testing.assert_array_equal(a[0].numpy(), np.full((4, 2), 1.0))
    np.testing.assert_array_equal(a[1].numpy(), np.zeros((4, 2)))
    bank.add("f64", {"q": (np.full((4, 2), 2.0), np.full((2, 4), 2.0))})  # cast to the bank dtype
    assert bank.gather(bank.indices(["f64"]))["q"][0].dtype == torch.float32


# -- lora= through the pipelines -------------------------------------------------


def test_audio2audio_lora_equals_merged_unet(engine):
    """``latents_from_audio(lora=)`` (unmerged) equals the same call on a UNet
    with the adapter merged, 1e-4."""
    import copy

    rng = np.random.default_rng(3)
    mel = torch.from_numpy(rng.standard_normal((1, 1, 40, 8)).astype(np.float32))
    lat_shape = pg.latent_shape(engine.modules, 1, 0.01)
    draws = {"init_noise": rng.standard_normal(lat_shape).astype(np.float32)}
    tok, unc = DummyTokenizer()(["hip hop beat"]), DummyTokenizer()([""])
    args = (mel, tok["input_ids"], tok["attention_mask"], unc["input_ids"], unc["attention_mask"])
    kw = dict(num_inference_steps=4, strength=0.5, guidance_scale=2.0, draws=draws)
    lora = engine.bank.adapter("hiphop")
    out = a2a.latents_from_audio(engine.modules, *args, lora=lora, lora_scale=LCFG.scale, **kw)
    merged = dataclasses.replace(engine.modules, unet=merge_lora(copy.deepcopy(engine.modules.unet), lora, LCFG))
    ref = a2a.latents_from_audio(merged, *args, **kw)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4)
    assert (out - a2a.latents_from_audio(engine.modules, *args, **kw)).abs().max() > 1e-4


def test_key_generator_families():
    """An unfolded key draws what ``generate(seed=)`` draws; a folded key's
    rows never draw a seeded request's latents, nor the loop stream's."""
    draw = lambda g: torch.randn(8, generator=g)
    assert torch.equal(draw(pg.key_generator((5,), 2)), draw(pg.row_generator(5, 2)))
    assert torch.equal(draw(pg.key_generator((5,))), draw(pg.loop_generator(5)))
    seeded = {tuple(draw(pg.row_generator(s, 0)).tolist()) for s in range(64)}
    for key in ((0, 0), (0, 1), (3, 0), (0, 0, 0)):
        for row in range(4):
            assert tuple(draw(pg.key_generator(key, row)).tolist()) not in seeded
        assert not torch.equal(draw(pg.key_generator(key)), draw(pg.key_generator(key, 0)))


# -- cli serve ---------------------------------------------------------------------


def _read_wav(path):
    with wave.open(path) as w:
        assert w.getframerate() == 16000
        return np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16).astype(np.float32) / 32767.0


def test_cli_serve_requests_writes_wavs_in_order(checkpoint, tmp_path, capsys):  # noqa: F811
    """``serve --requests`` on the HF-layout fixture with one PEFT adapter:
    one wav a request, in request order, each the engine's ``flush`` row."""
    from audioldm_tpu_torch.data.tokenizer import load_tokenizer

    mods = pg.AudioLDMModules.from_checkpoint(checkpoint, device="cpu")
    path = str(tmp_path / "a.safetensors")
    write_safetensors(path, export_peft_state_dict(port_adapter(mods.unet, 4, shift=0.3)))
    reqs = [{"prompt": "hip hop music", "adapter": "a"}, {"prompt": "rain on a roof", "adapter": None},
            {"prompt": "a dog barking", "adapter": "a"}]
    (tmp_path / "r.jsonl").write_text("".join(json.dumps(r) + "\n" for r in reqs))
    out = str(tmp_path / "out")
    cli.main(["serve", "--checkpoint", checkpoint, "--requests", str(tmp_path / "r.jsonl"), "--output", out,
              "--lora", f"a={path}", "--steps", "2", "--seconds", str(CKPT_SECONDS), "--fp32", "--device", "cpu",
              "--seed", "3", "--max-batch", "2"])
    assert "served 3 requests" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["000000.wav", "000001.wav", "000002.wav"]

    adapter, rank = import_peft_state_dict(read_safetensors(path))
    lcfg = tcfg.LoRAConfig(r=rank, lora_alpha=float(rank))
    eng = ServeEngine(mods, load_tokenizer(f"{checkpoint}/tokenizer"), lcfg, dtype=torch.float32, device="cpu",
                      bank=AdapterBank.from_adapters({"a": adapter}, lcfg, device="cpu"))
    for r in reqs:
        eng.submit(r["prompt"], r["adapter"])
    want = eng.flush(num_inference_steps=2, audio_length_in_s=CKPT_SECONDS, guidance_scale=2.5, seed=3, max_batch=2)
    got = np.stack([_read_wav(f"{out}/{i:06d}.wav") for i in range(3)])
    np.testing.assert_allclose(got, np.clip(want, -1, 1), atol=2e-4)  # 16-bit wav quantisation
    assert np.abs(got[0] - got[2]).max() > 1e-3 and np.abs(got[0] - got[1]).max() > 1e-3


def test_cli_serve_flag_checks():
    with pytest.raises(SystemExit, match="needs 2 processes.*torch.distributed.run"):
        cli.main(["serve", "--checkpoint", "unused", "--requests", "r.jsonl", "--output", "o", "--dp", "2"])
    with pytest.raises(SystemExit, match="exactly one of"):
        cli.main(["serve", "--checkpoint", "unused"])
    with pytest.raises(SystemExit, match="needs --output"):
        cli.main(["serve", "--checkpoint", "unused", "--requests", "r.jsonl"])
