"""The port's tensor parallelism (audioldm_tpu_torch/parallel/tp.py) at tp 2
and 3 and on a (dp, tp) = (2, 2) mesh over gloo on the CPU, against the JAX
package's tests/test_tp.py functions on conftest's virtual CPU devices, at
its TINY UNet (4 heads at every level).

The ranks run in processes spawned by ``test_torch_port_dist_workers.spawn``
(no jax there; the JAX references are computed here), joined under a
deadline that fails the test when missed. The JAX package checks its
all-reduce in the compiled HLO (tests/test_tp.py:147); the port counts the
``all_reduce`` calls of one UNet call instead: one a split attention or
feed-forward, three a transformer block at tp 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from audioldm_tpu.config import LoRAConfig as JaxLoRAConfig
from audioldm_tpu.config import TrainConfig as JaxTrainConfig
from audioldm_tpu.lora import init_lora as jax_init_lora
from audioldm_tpu.models.unet import apply_unet
from audioldm_tpu.parallel import make_tp_generate_fn as jax_tp_generate_fn
from audioldm_tpu.parallel import make_tp_mesh as jax_tp_mesh
from audioldm_tpu.parallel import make_tp_unet_step as jax_tp_unet_step
from audioldm_tpu.parallel import shard_modules as jax_shard_modules
from audioldm_tpu.parallel import shard_unet_params as jax_shard_unet_params
from audioldm_tpu.parallel import unet_tp_specs as jax_unet_tp_specs
from audioldm_tpu.parallel.tp import _interleave_geglu as jax_interleave_geglu
from audioldm_tpu.pipeline.generate import init_noise as jax_init_noise
from audioldm_tpu.train import trainer as jax_trainer
from audioldm_tpu_torch import config as tcfg
from audioldm_tpu_torch.ckpt import from_jax_params, lora_from_jax
from audioldm_tpu_torch.ckpt.hf_bridge import _UNET_RULES
from audioldm_tpu_torch.models.unet import UNet2DConditionModel
from audioldm_tpu_torch.parallel import unet_tp_specs
from audioldm_tpu_torch.parallel.tp import _interleave_geglu
import test_torch_port_dist_workers as W
from test_torch_port_lora import _flat
from test_torch_port_models import numpy_params
from test_torch_port_train import jax_draws
from tests.test_tp import TINY, _inputs, _tiny_modules

PORT_TINY = tcfg.UNetConfig(**TINY.__dict__)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mods():
    """tests/test_tp.py's tiny JAX modules (its configs), the weights drawn
    from numpy seeds (``numpy_params``: the JAX initialisers take long to
    trace)."""
    from audioldm_tpu.models.clap_text import init_clap_text
    from audioldm_tpu.models.unet import init_unet
    from audioldm_tpu.models.vae import init_vae
    from audioldm_tpu.models.vocoder import init_vocoder

    cfg = jax.eval_shape(_tiny_modules)  # the configs; no weights are drawn
    return cfg._replace(unet=numpy_params(init_unet, cfg.unet_cfg, 10), vae=numpy_params(init_vae, cfg.vae_cfg, 11),
                        text_encoder=numpy_params(init_clap_text, cfg.text_cfg, 12),
                        vocoder=numpy_params(init_vocoder, cfg.vocoder_cfg, 13))


def _cfgs(jm) -> tuple:
    return tuple(t(**c.__dict__) for t, c in ((tcfg.UNetConfig, jm.unet_cfg), (tcfg.VAEConfig, jm.vae_cfg),
                                              (tcfg.ClapTextConfig, jm.text_cfg), (tcfg.VocoderConfig, jm.vocoder_cfg)))


def _sds(jm) -> dict:
    return from_jax_params(unet=jax.device_get(jm.unet), vae=jax.device_get(jm.vae),
                           text_encoder=jax.device_get(jm.text_encoder), vocoder=jax.device_get(jm.vocoder))


def _torch_name(keys) -> str:
    """The port's parameter name of a JAX UNet leaf (ckpt.hf_bridge's rules)."""
    module = ".".join(keys[:-1])
    for old, new in _UNET_RULES:
        module = module.replace(old, new)
    return f"{module}.{ {'kernel': 'weight', 'scale': 'weight'}.get(keys[-1], keys[-1]) }"


def _torch_spec(spec: P, leaf_ndim: int) -> tuple:
    """A JAX spec in torch's layout: a 2-D kernel ``[in, out]`` is the
    transpose of a ``[out, in]`` weight."""
    spec = tuple(spec)
    if not spec:
        return ()
    return tuple(reversed(spec)) if leaf_ndim == 2 else spec


@pytest.mark.parametrize("tp", [1, 2, 3])
def test_unet_tp_specs_match_jax_path_by_path(mods, tp):
    """tests/test_tp.py:52,79: every UNet parameter gets the JAX spec of its
    leaf, in torch's layout (attention q/k/v columns and to_out rows always;
    the GEGLU columns and the FF out rows only when tp > 1 divides the
    hidden width), and no other parameter is split."""
    unet = UNet2DConditionModel(PORT_TINY)
    got = unet_tp_specs(unet, tp)
    flat = jax.tree_util.tree_flatten_with_path(jax_unet_tp_specs(mods.unet, tp))[0]
    leaves = dict(jax.tree_util.tree_flatten_with_path(mods.unet)[0])
    want = {}
    for path, spec in flat:
        keys = [str(getattr(k, "key", getattr(k, "idx", ""))) for k in path]
        want[_torch_name(keys)] = _torch_spec(spec, leaves[path].ndim)
    assert got == want
    assert any(s == ("tp", None) for s in got.values()) and any(s == (None, "tp") for s in got.values())
    assert (("tp",) in got.values()) == (tp == 2)  # the GEGLU bias splits with its columns


@pytest.mark.parametrize("tp", [2, 4])
def test_interleave_geglu_matches_jax(tp):
    """The shard-interleaved GEGLU layout, exactly (atol 0): on the JAX
    ``[in, out]`` kernel along its last dim, on a bias, and on torch's
    ``[out, in]`` weight along dim 0."""
    rng = np.random.default_rng(tp)
    kernel, bias = rng.standard_normal((16, 128)).astype(np.float32), rng.standard_normal(128).astype(np.float32)
    for x in (kernel, bias):
        want = np.asarray(jax_interleave_geglu(jnp.asarray(x), tp))
        np.testing.assert_array_equal(_interleave_geglu(torch.from_numpy(x), tp).numpy(), want)
    want = np.asarray(jax_interleave_geglu(jnp.asarray(kernel), tp)).T
    np.testing.assert_array_equal(_interleave_geglu(torch.from_numpy(kernel.T.copy()), tp, dim=0).numpy(), want)


def _unet_case():
    lat, t, lbl = _inputs(TINY)
    return lat, t, lbl


def _port_unet_case(mods):
    lat, t, lbl = _unet_case()
    sd = from_jax_params(unet=jax.device_get(mods.unet))["unet"]
    return (PORT_TINY, sd, np.asarray(lat).transpose(0, 3, 1, 2).copy(), np.asarray(t).astype(np.int64), np.asarray(lbl))


GEN_IDS = dict(kw=dict(num_inference_steps=2, audio_length_in_s=0.01, guidance_scale=2.5))


def _prompts():
    ids = jnp.full((1, 6), 5, jnp.int32).at[:, 0].set(0)
    mask = jnp.ones((1, 6), jnp.int32)
    u_ids = jnp.full((1, 6), 1, jnp.int32).at[:, 0].set(0)
    u_mask = jnp.ones((1, 6), jnp.int32).at[:, 1:].set(0)
    return ids, mask, u_ids, u_mask


def _lora(mods):
    lora = jax_init_lora(jax.random.PRNGKey(9), mods.unet, JaxLoRAConfig(r=2, lora_alpha=4.0))
    return jax.tree.map(lambda x: x + 0.05, lora)  # B nonzero, so that the adapter is felt


@pytest.fixture(scope="module")
def tp2_ranks(mods, tmp_path_factory):
    """One tp-2 spawn: ``make_tp_generate_fn`` without and with the
    adapter, from the JAX init latents, then the TP UNet step."""
    kw = GEN_IDS["kw"]
    lat, _ = jax_init_noise(mods, jax.random.PRNGKey(7), 1, kw["audio_length_in_s"])
    tensors = {p: (a.detach(), b.detach()) for p, a, b in lora_from_jax(jax.device_get(_lora(mods))).items()}
    return W.spawn(W.tp_generate_worker, 2, tmp_path_factory.mktemp("tp2"), _cfgs(mods), _sds(mods),
                   tuple(np.asarray(x) for x in _prompts()), np.asarray(lat).transpose(0, 3, 1, 2).copy(), tensors, kw,
                   _port_unet_case(mods))


@pytest.mark.parametrize("tp,jax_tp", [(2, 2), (3, 8)])
def test_tp_unet_step_matches_jax(mods, request, tmp_path, tp, jax_tp):
    """tests/test_tp.py:134,137: the port's TP UNet step against the JAX
    ``make_tp_unet_step`` (atol 2e-5). At tp 2 (JAX at tp 2) every attention
    (4 heads) and every FF (hidden width 64 or 128) splits: 3 split blocks a
    transformer block, 4 transformer blocks, one all-reduce each a UNet
    call. Heads that do not divide: JAX at tp 8 (its test's case; the JAX
    mesh splits the 16 channels), the port at tp 3 (three processes, not
    eight), where neither the heads nor the FF widths divide: every block
    runs whole on every rank, no all-reduce, the same numbers."""
    lat, t, lbl = _unet_case()
    mesh = jax_tp_mesh(jax_tp)
    ref = np.asarray(jax_tp_unet_step(TINY, mesh)(jax_shard_unet_params(mesh, mods.unet), lat, t, lbl))
    if tp == 2:
        ranks = [r["unet"] for r in request.getfixturevalue("tp2_ranks")]
    else:
        ranks = W.spawn(W.tp_unet_worker, tp, tmp_path, *_port_unet_case(mods))
    from audioldm_tpu_torch.models.unet import BasicTransformerBlock

    blocks = sum(isinstance(m, BasicTransformerBlock) for m in UNet2DConditionModel(PORT_TINY).modules())
    n_blocks = blocks if tp == 2 else 0
    assert blocks == 4  # level 0: one down, two up; one in the mid block
    for r in ranks:
        np.testing.assert_allclose(r["eps"], ref.transpose(0, 3, 1, 2), atol=2e-5)
        assert r["split_blocks"] == 3 * n_blocks and r["all_reduces"] == 3 * n_blocks
    single = np.asarray(apply_unet(mods.unet, TINY, lat, t, class_labels=lbl))
    np.testing.assert_allclose(ref, single, atol=2e-5)


def test_tp_generate_matches_jax_with_and_without_an_adapter(mods, tp2_ranks):
    """tests/test_tp.py:187: ``make_tp_generate_fn`` at tp 2 against the JAX
    one on ``make_tp_mesh(2)``, 2 DDIM steps, 0.01 s, CFG 2.5, fp32, the port
    given the JAX init latents; without and with an adapter (B nonzero, so it
    is felt), atol 2e-5."""
    mesh = jax_tp_mesh(2)
    fn = jax_tp_generate_fn(jax_shard_modules(mesh, mods), mesh, dtype=jnp.float32, **GEN_IDS["kw"])
    ref, ref_lora = (np.asarray(fn(*_prompts(), jax.random.PRNGKey(7), lora=x)) for x in (None, _lora(mods)))
    assert np.abs(ref - ref_lora).max() > 1e-7
    for r in tp2_ranks:
        np.testing.assert_allclose(r["plain"], ref, atol=2e-5)
        np.testing.assert_allclose(r["lora"], ref_lora, atol=2e-5)


def test_dp_tp_train_step_matches_the_single_device_jax_step(mods, tmp_path):
    """tests/test_tp.py:251: one LoRA step on a (dp, tp) = (2, 2) mesh, four
    ranks, against the JAX single-device ``make_train_step`` on the same
    global batch of 4 and draws: loss rtol 1e-5, grad norm rtol 1e-4,
    adapters atol 1e-5 (default learning rate 1e-5; fresh adapters, B = 0).
    Every rank ends with the same adapters."""
    lcfg = JaxLoRAConfig(r=2, lora_alpha=4.0)
    lora = jax_init_lora(jax.random.PRNGKey(1), mods.unet, lcfg)
    opt = jax_trainer.make_optimizer(JaxTrainConfig(max_train_steps=10))
    mel = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (4, 16, 8, 1), jnp.float32))
    ids = np.full((4, 6), 5, np.int32)
    ids[:, 0] = 0
    batch = {"log_mel_spec": jnp.asarray(mel), "input_ids": jnp.asarray(ids), "attention_mask": jnp.ones((4, 6), jnp.int32)}
    rng = jax.random.PRNGKey(3)
    state, m = jax_trainer.make_train_step(mods, opt, lcfg)(jax_trainer.init_train_state(lora, opt), batch, rng)
    ref = dict(_flat(jax.device_get(state.lora)))

    port_batch = {"log_mel_spec": mel.transpose(0, 3, 1, 2).copy(), "input_ids": ids,
                  "attention_mask": np.ones((4, 6), np.int32)}
    tensors = {p: (a.detach(), b.detach()) for p, a, b in lora_from_jax(jax.device_get(lora)).items()}
    ranks = W.spawn(W.tp_train_worker, 4, tmp_path, 2, 2, _cfgs(mods), _sds(mods), tensors,
                    tcfg.LoRAConfig(r=2, lora_alpha=4.0), tcfg.TrainConfig(max_train_steps=10), port_batch,
                    jax_draws(rng, (4, 8, 4, 4)))
    for r in ranks:
        assert r["step"] == 1
        np.testing.assert_allclose(r["loss"], float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], float(m["grad_norm"]), rtol=1e-4)
        for key, want in ref.items():
            np.testing.assert_allclose(r["lora"][key], want, atol=1e-5, err_msg=key)
            np.testing.assert_array_equal(r["lora"][key], ranks[0]["lora"][key])
