"""The port's data parallelism (audioldm_tpu_torch/parallel/mesh.py,
``train_step(mesh=)``, ``distill_step(mesh=)``, ``ServeEngine(mesh=)`` and
the daemon's follower loop) at world size 2 over gloo on the CPU, against
the JAX package's mesh functions on conftest's virtual CPU devices and
against the port at world size 1, at the tiny widths of the other port
tests.

The ranks run in processes spawned by ``test_torch_port_dist_workers.spawn``
(its workers import neither jax nor audioldm_tpu; the JAX references are
computed here and handed over as arrays), joined under a deadline that
fails the test when missed. torch cannot reproduce ``jax.random``, so the
JAX draws are handed to the port as ``draws``, whole: each rank keeps its
rows. Optimizer steps run at the default learning rate 1e-5: Adam moves an
entry by about one learning rate whatever its gradient, so a gradient that
differs in sign between two runs near zero differs by two learning rates,
which 1e-5 keeps inside the adapters' bound.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioldm_tpu.config import LoRAConfig as JaxLoRAConfig
from audioldm_tpu.config import TrainConfig as JaxTrainConfig
from audioldm_tpu.parallel import make_mesh as jax_make_mesh
from audioldm_tpu.serve import ServeEngine as JaxServeEngine
from audioldm_tpu.train import distill as jax_distill
from audioldm_tpu.train import trainer as jax_trainer
from audioldm_tpu_torch import config as tcfg
from audioldm_tpu_torch.ckpt import lora_from_jax, lora_to_numpy
from audioldm_tpu_torch.lora import LoRAAdapters
from audioldm_tpu_torch.parallel import Mesh, local_rows, shard_batch
from audioldm_tpu_torch.pipeline import generate as pg
from audioldm_tpu_torch.serve import AdapterBank, ServeEngine
from audioldm_tpu_torch.train import distill as port_distill
from audioldm_tpu_torch.train import trainer as port_trainer
import test_torch_port_dist_workers as W
from test_torch_port_distill import _batch as distill_batch
from test_torch_port_distill import _jax_mods, jax_distill_draws
from test_torch_port_lora import _flat, jax_adapters
from test_torch_port_pipeline import TEXT, UNET, VAE, VOC, jax_modules, port_modules  # noqa: F401 (fixture)
from test_torch_port_serve import GEN, JLCFG, world  # noqa: F401 (fixture)
from test_torch_port_serve import LCFG as SERVE_LCFG
from test_torch_port_train import _batch, jax_draws
from tests.test_pipeline import TINY_TEXT, TINY_UNET, TINY_VAE, TINY_VOC

LCFG = tcfg.LoRAConfig()
TRAIN = dict(max_train_steps=10)  # the default learning rate, 1e-5
CFGS = (tcfg.UNetConfig(**UNET), tcfg.VAEConfig(**VAE), tcfg.ClapTextConfig(**TEXT), tcfg.VocoderConfig(**VOC))
SERVE_CFGS = tuple(t(**j.__dict__) for t, j in ((tcfg.UNetConfig, TINY_UNET), (tcfg.VAEConfig, TINY_VAE),
                                                  (tcfg.ClapTextConfig, TINY_TEXT), (tcfg.VocoderConfig, TINY_VOC)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sds(mods) -> dict:
    return {n: getattr(mods, n).state_dict() for n in ("unet", "vae", "text_encoder", "vocoder")}


def _tensors(lora: LoRAAdapters) -> dict:
    return {p: (a.detach().clone(), b.detach().clone()) for p, a, b in lora.items()}


def _mesh(k: int, i: int) -> Mesh:
    return Mesh({"dp": k}, i, {"dp": i}, {}, torch.device("cpu"))


@pytest.mark.parametrize("axis", [0, 1])
def test_shard_batch_keeps_this_ranks_rows(axis):
    """Contiguous rows on ``batch_axis`` (1: the ``[accum, micro, ...]``
    layout), numpy and torch leaves alike, nested containers walked, leaves
    of no more dims than the axis whole; a batch that does not split
    raises."""
    x = np.arange(4 * 6).reshape(4, 6) if axis == 0 else np.arange(2 * 4 * 3).reshape(2, 4, 3)
    batch = {"x": x, "t": torch.from_numpy(x.copy()), "scalar": np.float32(3.0), "nest": [x], "v": np.arange(4)}
    for i in range(2):
        out = shard_batch(_mesh(2, i), batch, batch_axis=axis)
        want = x[2 * i : 2 * i + 2] if axis == 0 else x[:, 2 * i : 2 * i + 2]
        np.testing.assert_array_equal(out["x"], want)
        np.testing.assert_array_equal(out["t"].numpy(), want)
        np.testing.assert_array_equal(out["nest"][0], want)
        assert out["scalar"] == 3.0
        if axis == 0:
            np.testing.assert_array_equal(out["v"], np.arange(2 * i, 2 * i + 2))
        else:
            np.testing.assert_array_equal(out["v"], np.arange(4))  # 1-D: no micro axis
    assert shard_batch(_mesh(1, 0), batch)["x"] is x
    with pytest.raises(ValueError, match="do not split"):
        shard_batch(_mesh(3, 0), {"x": np.zeros((4, 2))})
    np.testing.assert_array_equal(local_rows(_mesh(2, 1), torch.arange(6)).numpy(), [3, 4, 5])


def test_spawn_fails_a_rank_past_its_deadline(tmp_path):
    """A rank still running at the deadline is killed and the test fails."""
    with pytest.raises(AssertionError, match="did not finish within 3 s"):
        W.spawn(W.noop_worker, 1, tmp_path, 60.0, deadline=3.0)


def _jax_train(jm, tree, jax_batch, rng, mesh, accum):
    opt = jax_trainer.make_optimizer(JaxTrainConfig(**TRAIN))
    step = jax_trainer.make_train_step(_jax_mods(jm), opt, JaxLoRAConfig(), mesh=mesh, grad_accum=accum)
    state, m = step(jax_trainer.init_train_state(tree, opt), jax_batch, rng)
    return float(m["loss"]), float(m["grad_norm"]), dict(_flat(jax.device_get(state.lora)))


def _train_case(jax_modules, accum):  # noqa: F811
    """(JAX adapter tree, port batch, JAX batch, rng, port draws) of a
    global batch of 4: flat, or 2 micro-batches of 2 under accumulation."""
    tree = jax_adapters(jax_modules.unet, LCFG.target_modules, LCFG.r, 7)
    port_batch, jax_batch = _batch(b=4)
    rng = jax.random.PRNGKey(4)
    if accum == 1:
        return tree, port_batch, jax_batch, rng, jax_draws(rng, (4, 8, 4, 4))
    micro = [jax_draws(k, (2, 8, 4, 4)) for k in jax.random.split(rng, 2)]
    draws = {k: torch.stack([d[k] for d in micro]) for k in micro[0]}
    return tree, port_trainer.to_accum_layout(port_batch, 2), jax_trainer.to_accum_layout(jax_batch, 2), rng, draws


@pytest.fixture(scope="module")
def dp_train_ranks(jax_modules, tmp_path_factory):  # noqa: F811
    """Both cases of ``_train_case`` at world size 2, in one spawn."""
    mods = port_modules(jax_modules)
    tree = _train_case(jax_modules, 1)[0]
    cases = [(*_train_case(jax_modules, a)[1:2], _train_case(jax_modules, a)[4], a) for a in (1, 2)]
    ranks = W.spawn(W.train_worker, 2, tmp_path_factory.mktemp("dp_train"), CFGS, _sds(mods),
                    _tensors(lora_from_jax(tree)), LCFG, tcfg.TrainConfig(**TRAIN), cases)
    return {a: [r[i] for r in ranks] for i, a in enumerate((1, 2))}


@pytest.mark.parametrize("accum", [1, 2])
def test_dp_train_step_matches_the_jax_mesh_step_and_world_one(jax_modules, dp_train_ranks, accum):  # noqa: F811
    """A world-2 ``train_step(mesh=)`` on a global batch of 4 (with
    accumulation: 2 micro-batches of 2, each split over the ranks) against
    the JAX ``make_train_step(mesh=make_mesh(2))`` on the same batch and
    draws (loss rtol 1e-5, grad norm 1e-4, adapters atol 1e-5) and against
    the port's single-device step (adapters atol 1e-6); both ranks end with
    the same adapters."""
    tree, port_batch, jax_batch, rng, draws = _train_case(jax_modules, accum)
    ref_loss, ref_norm, ref = _jax_train(jax_modules, jax.tree.map(jnp.asarray, tree), jax_batch, rng,
                                         jax_make_mesh(2), accum)

    mods = W.frozen(port_modules(jax_modules))
    state = port_trainer.init_train_state(lora_from_jax(tree), tcfg.TrainConfig(**TRAIN))
    state, m1 = port_trainer.train_step(state, mods, port_batch, LCFG, grad_accum=accum, draws=draws)
    one = dict(_flat(lora_to_numpy(state.lora)))

    ranks = dp_train_ranks[accum]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], ref_loss, rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], ref_norm, rtol=1e-4)
        np.testing.assert_allclose(r["loss"], m1["loss"].item(), rtol=1e-6)
        for key, want in ref.items():
            np.testing.assert_allclose(r["lora"][key], want, atol=1e-5, err_msg=key)
            np.testing.assert_allclose(r["lora"][key], one[key], atol=1e-6, err_msg=key)
            np.testing.assert_array_equal(r["lora"][key], ranks[0]["lora"][key])
    assert max(np.abs(one[k] - np.asarray(tree_v)).max() for k, tree_v in _flat(tree)) > 1e-6  # the step moved them


def test_dp_distill_step_matches_the_jax_mesh_step_and_world_one(jax_modules, tmp_path):  # noqa: F811
    """tests/test_distill.py:177 through the port: a world-2
    ``distill_step(mesh=)`` on a global batch of 4 with the JAX draws
    against the JAX ``make_distill_step(mesh=make_mesh(2))`` (loss 1e-5,
    student adapters atol 1e-5); then two steps from one seeded generator
    (the draws made whole on every rank, w ~ U[2, 3)) against the port at
    world size 1 (losses 1e-6 relative, student and EMA atol 1e-6)."""
    tree = jax_adapters(jax_modules.unet, LCFG.target_modules, LCFG.r, 7)
    port_batch, jax_batch = distill_batch(b=4)
    rng = jax.random.PRNGKey(3)
    opt = jax_trainer.make_optimizer(JaxTrainConfig(**TRAIN))
    jtree = jax.tree.map(jnp.asarray, tree)
    step = jax_distill.make_distill_step(_jax_mods(jax_modules), opt, JaxLoRAConfig(), mesh=jax_make_mesh(2), w=2.0)
    jstate, jm = step(jax_distill.init_distill_state(jtree, opt), jax_batch, rng)
    ref, ref_loss = dict(_flat(jax.device_get(jstate.lora))), float(jm["loss"])

    mods = W.frozen(port_modules(jax_modules))
    train_cfg = tcfg.TrainConfig(**TRAIN)
    uncond = {k: port_batch[k] for k in ("uncond_ids", "uncond_mask")}
    base = {k: port_batch[k] for k in ("log_mel_spec", "input_ids", "attention_mask")}
    runs = [(2.0, None, 1, jax_distill_draws(rng, (4, 8, 4, 4))), ((2.0, 3.0), 11, 2, None)]
    ranks = W.spawn(W.distill_worker, 2, tmp_path, CFGS, _sds(mods), _tensors(lora_from_jax(tree)), LCFG, train_cfg,
                    base, uncond, runs)
    for r, _ in ranks:
        np.testing.assert_allclose(r["losses"][0], ref_loss, rtol=1e-5)
        for key, want in ref.items():
            np.testing.assert_allclose(r["lora"][key], want, atol=1e-5, err_msg=key)

    state = port_distill.init_distill_state(lora_from_jax(tree), train_cfg)
    gen, losses = torch.Generator().manual_seed(11), []
    for _ in range(2):
        state, m = port_distill.distill_step(state, mods, port_batch, LCFG, w=(2.0, 3.0), generator=gen)
        losses.append(m["loss"].item())
    one = {"lora": W.adapters_np(state.lora), "ema": W.adapters_np(state.ema_lora)}
    ranks = [r for _, r in ranks]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-6)
        for which in ("lora", "ema"):
            for key, want in one[which].items():
                np.testing.assert_allclose(r[which][key], want, atol=1e-6, err_msg=f"{which} {key}")
                np.testing.assert_array_equal(r[which][key], ranks[0][which][key])


PROMPTS = ["hip hop beat"] * 8
MIXED = ["hiphop", "base", "jazz", "base", "hiphop", "jazz", "base", "hiphop"]
REQUESTS = [("hip hop beat", "hiphop"), ("a dog barking", "hiphop")]


def _bank_tensors(bank) -> dict:
    return {n: _tensors(bank.adapter(n)) for n in bank.names if n != "base"}


def _new_adapter(bank) -> dict:
    gen = torch.Generator().manual_seed(21)
    return {p: (torch.randn(a.shape, generator=gen) * 0.3, torch.randn(b.shape, generator=gen) * 0.3)
            for p, a, b in bank.adapter("hiphop").items()}


@pytest.fixture(scope="module")
def serve_ranks(world, tmp_path_factory):  # noqa: F811
    """One world-2 spawn: the engine's calls, then the daemon (rank 0 a
    ``Microbatcher``, rank 1 ``follow``)."""
    _, _, mods, bank = world
    calls = [(PROMPTS, MIXED, GEN), (["quiet piano"], ["jazz"], GEN)]
    return W.spawn(W.serve_worker, 2, tmp_path_factory.mktemp("serve"), SERVE_CFGS, _sds(mods), _bank_tensors(bank),
                   SERVE_LCFG, (1, 2, 4, 8, 16), calls, _new_adapter(bank), REQUESTS)


def test_dp_engine_matches_the_jax_mesh_engine_and_world_one(world, serve_ranks, monkeypatch):  # noqa: F811
    """tests/test_serve.py:139 through the port: ``ServeEngine(mesh=)`` at
    world size 2 on a mixed batch of 8 (rank-r route, 4 rows a rank) against
    the JAX mesh engine on ``make_mesh(2)`` fed the port's init latents (the
    JAX ``init_noise`` patched to return them), atol 1e-5, and against the
    port's engine without a mesh on the rank-r route (buckets (8,)); a
    request alone pads to a bucket of 1, which does not divide the mesh and
    runs whole on both ranks. Both ranks return the whole batch, and count
    the batches by route as one rank does."""
    jm, jbank, mods, bank = world
    shape = pg.latent_shape(mods, 1, GEN["audio_length_in_s"])[1:]
    lat = torch.stack([torch.randn(shape, generator=pg.key_generator((GEN["seed"],), i)) for i in range(8)])
    jgen = importlib.import_module("audioldm_tpu.pipeline.generate")
    monkeypatch.setattr(jgen, "init_noise", lambda m, rng, b, s, latent_keys=None: (
        jnp.asarray(lat.numpy().transpose(0, 2, 3, 1)), jax.random.split(rng)[0]))
    jeng = JaxServeEngine(jm, W.Tokenizer(), JLCFG, bank=jbank, mesh=jax_make_mesh(2), dtype=jnp.float32)
    ref = np.asarray(jeng.generate(PROMPTS, adapters=MIXED, **GEN))

    plain = ServeEngine(mods, W.Tokenizer(), SERVE_LCFG, bank=bank, dtype=torch.float32, bucket_sizes=(8,), device="cpu")
    one = plain.generate(PROMPTS, adapters=MIXED, **GEN)
    alone = ServeEngine(mods, W.Tokenizer(), SERVE_LCFG, bank=bank, dtype=torch.float32, device="cpu")
    one_alone = alone.generate(["quiet piano"], adapters=["jazz"], **GEN)
    np.testing.assert_allclose(one, ref, atol=1e-5)  # the port's rank-r route and the JAX mesh engine's

    for r in (x["engine"] for x in serve_ranks):
        assert r["wavs"][0].shape == (8, 160)
        np.testing.assert_allclose(r["wavs"][0], ref, atol=1e-5)
        np.testing.assert_allclose(r["wavs"][0], one, atol=1e-6)
        np.testing.assert_allclose(r["wavs"][1], one_alone, atol=1e-6)
        assert r["batches"] == {("rank_r", 8): 1, ("merged", 1): 1}
    assert np.abs(ref[0] - ref[1]).max() > 1e-4  # the adapters are felt


def test_daemon_followers_serve_a_batch_and_a_hot_load(world, serve_ranks):  # noqa: F811
    """The daemon at world size 2: rank 0's ``Microbatcher`` serves one batch
    of two requests and a hot-load of adapter "c" with a request on it,
    rank 1 ``follow``s: three engine calls reach it, both banks end with
    "c" in the same slot, and the waveforms equal one rank's engine on the
    same batch keys. A request for an unknown adapter is refused on rank 0
    without reaching rank 1."""
    _, _, mods, bank = world
    new, requests = _new_adapter(bank), REQUESTS
    ranks = [x["daemon"] for x in serve_ranks]
    assert ranks[1]["calls"] == 3
    assert ranks[0]["names"] == ranks[1]["names"] and "c" in ranks[0]["names"]
    assert "unknown adapter" in ranks[0]["refused"]

    fresh = AdapterBank.from_adapters({n: LoRAAdapters(t) for n, t in _bank_tensors(bank).items()}, SERVE_LCFG,
                                      device="cpu")  # the workers' bank, slot for slot; the fixture's stays as it is
    eng = ServeEngine(mods, W.Tokenizer(), SERVE_LCFG, bank=fresh, dtype=torch.float32, bucket_sizes=(1, 2, 4),
                      device="cpu")
    kw = dict(num_inference_steps=2, audio_length_in_s=0.01, guidance_scale=2.0)
    want = eng.generate([p for p, _ in requests], adapters=[a for _, a in requests], rng_key=(3, 0), **kw)
    np.testing.assert_allclose(ranks[0]["wavs"], want, atol=1e-6)
    eng.load_adapter("c", LoRAAdapters(new), SERVE_LCFG.r, SERVE_LCFG.lora_alpha)
    want_c = eng.generate(["hip hop beat"], adapters=["c"], rng_key=(3, 1), **kw)
    np.testing.assert_allclose(ranks[0]["on_c"], want_c[0], atol=1e-6)
    assert np.abs(ranks[0]["on_c"] - want[0]).max() > 1e-4
