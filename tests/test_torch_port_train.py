"""The port's LoRA training slice (audioldm_tpu_torch/train, VAE encode,
``add_noise``) against the JAX package, at tiny widths on the CPU.

torch cannot reproduce ``jax.random``, so each test makes the three draws of
the loss (posterior eps, noise, t) with ``jax.random.split(rng, 3)`` exactly
as the JAX ``lora_loss_fn`` does and hands them to the port as tensors.
Weights, adapters and batches come from numpy seeds. One case forces the JAX
flash route (Pallas K3-K5 in interpret mode) while the port's autograd
Function runs the plain versions of the same kernels.
"""

import copy
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audioldm_tpu.config import DDIMConfig, LoRAConfig as JaxLoRAConfig
from audioldm_tpu.config import TrainConfig as JaxTrainConfig
from audioldm_tpu.config import VAEConfig
from audioldm_tpu.lora import adapter as jax_lora
from audioldm_tpu.models import scheduler as jax_sched
from audioldm_tpu.models import vae as jax_vae
from audioldm_tpu.train import trainer as jax_trainer
from audioldm_tpu_torch import config as tcfg
from audioldm_tpu_torch.ckpt import from_jax_params, lora_from_jax, lora_to_numpy, read_safetensors
from audioldm_tpu_torch.kernels import flash_attention as port_fa
from audioldm_tpu_torch.lora import import_peft_state_dict, init_lora
from audioldm_tpu_torch.models import scheduler as port_sched
from audioldm_tpu_torch.models.vae import AutoencoderKL
from audioldm_tpu_torch.train import trainer as port_trainer
from test_torch_port_lora import _flat, jax_adapters
from test_torch_port_models import VAE, numpy_params
from test_torch_port_pipeline import jax_modules, port_modules  # noqa: F401 (fixture)

LCFG, JLCFG = tcfg.LoRAConfig(), JaxLoRAConfig()


def _np(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _batch(b=2, t=16, f=8, seed=0):
    """(port batch NCHW, JAX batch NHWC) of the same numbers."""
    mel = _np(seed, (b, t, f, 1))
    ids = np.array([[0, 45, 77, 12, 2, 1], [0, 9, 2, 1, 1, 1]] * b, np.int32)[:b]
    mask = (ids != 1).astype(np.int32)
    port = {"log_mel_spec": mel.transpose(0, 3, 1, 2), "input_ids": ids, "attention_mask": mask}
    jx = {"log_mel_spec": jnp.asarray(mel), "input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask)}
    return port, jx


def jax_draws(rng, latent_shape_nhwc, num_train_timesteps=1000):
    """The draws of the JAX ``lora_loss_fn`` for ``rng``, as the port's
    ``draws`` (NCHW)."""
    k_latent, k_noise, k_t = jax.random.split(rng, 3)
    eps = jax.random.normal(k_latent, latent_shape_nhwc, jnp.float32)
    noise = jax.random.normal(k_noise, latent_shape_nhwc, jnp.float32)
    t = jax.random.randint(k_t, (latent_shape_nhwc[0],), 0, num_train_timesteps)
    return {"latent_eps": torch.from_numpy(np.asarray(eps).transpose(0, 3, 1, 2).copy()),
            "noise": torch.from_numpy(np.asarray(noise).transpose(0, 3, 1, 2).copy()),
            "t": torch.from_numpy(np.asarray(t).astype(np.int64))}


def _grads(adapters):
    return {f"{p}.{n}": g.grad.numpy() for p, a, b in adapters.items() for n, g in (("a", a), ("b", b))}


@pytest.fixture
def mods(jax_modules):  # noqa: F811
    return port_modules(jax_modules)


def _jit_loss_and_grad(jm):
    # the fixture's numpy weights become jax arrays: traced token ids index them
    jm = jm._replace(**{n: jax.tree.map(jnp.asarray, getattr(jm, n)) for n in ("unet", "vae", "text_encoder")})
    return jax.jit(jax.value_and_grad(lambda lora, batch, rng: jax_trainer.lora_loss_fn(lora, jm, batch, rng, JLCFG.scale)[0]))


@pytest.fixture(scope="module")
def jax_loss_and_grad(jax_modules):  # noqa: F811
    """One jitted value_and_grad of the JAX loss (the flash route off)."""
    return _jit_loss_and_grad(jax_modules)


@pytest.mark.parametrize("frames,bins", [(16, 8), (15, 7)])
def test_vae_encode_matches_jax(frames, bins):
    """mean, clipped logvar and ``sample`` with a given eps, 1e-4; the odd
    size goes through the (0, 1) pad before the stride-2 conv with an odd
    extent. The weights are scaled up so that the logvar clip is hit."""
    params = numpy_params(jax_vae.init_vae, VAEConfig(**VAE), 1)
    params["quant_conv"]["kernel"] = params["quant_conv"]["kernel"] * 60.0
    vae = AutoencoderKL(tcfg.VAEConfig(**VAE))
    vae.load_state_dict(from_jax_params(vae=params)["vae"], strict=True)
    x = _np(2, (2, frames, bins, 1))
    ref = jax.jit(jax_vae.encode, static_argnums=1)(params, VAEConfig(**VAE), jnp.asarray(x))
    with torch.no_grad():
        dist = vae.encode(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    want_shape = (2, 4, (frames + 1 - 3) // 2 + 1, (bins + 1 - 3) // 2 + 1)  # pad 1, kernel 3, stride 2
    assert tuple(dist.mean.shape) == tuple(dist.logvar.shape) == want_shape
    np.testing.assert_allclose(dist.mean.numpy(), np.asarray(ref.mean).transpose(0, 3, 1, 2), atol=1e-4)
    np.testing.assert_allclose(dist.logvar.numpy(), np.asarray(ref.logvar).transpose(0, 3, 1, 2), atol=1e-4)
    assert dist.logvar.max() == 20.0 or dist.logvar.min() == -30.0
    assert dist.mode is dist.mean
    eps = 0.01 * _np(3, np.asarray(ref.mean).shape)
    want = np.asarray(ref.mean + jnp.exp(0.5 * ref.logvar) * eps).transpose(0, 3, 1, 2)
    got = dist.sample(eps=torch.from_numpy(eps.transpose(0, 3, 1, 2).copy())).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)  # std reaches e^10 at the clip
    a = dist.sample(torch.Generator().manual_seed(0))
    assert torch.equal(a, dist.sample(torch.Generator().manual_seed(0))) and not torch.equal(a, dist.mean)


def test_add_noise_with_per_row_timesteps_matches_jax():
    sj, st = jax_sched.make_schedule(DDIMConfig()), port_sched.make_schedule(tcfg.DDIMConfig())
    x, noise, t = _np(4, (3, 4, 6, 5)), _np(5, (3, 4, 6, 5)), np.array([0, 517, 999])
    ref = np.asarray(jax_sched.add_noise(sj, jnp.asarray(x), jnp.asarray(noise), jnp.asarray(t)))
    out = port_sched.add_noise(st, torch.from_numpy(x), torch.from_numpy(noise), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert not np.allclose(out[0], out[2])


@pytest.mark.parametrize("warmup", [0, 10])
def test_lr_schedule_matches_optax(warmup):
    kw = dict(learning_rate=1e-5, max_train_steps=100, lr_warmup_steps=warmup)
    ref = jax_trainer.make_lr_schedule(JaxTrainConfig(**kw))
    got = port_trainer.make_lr_schedule(tcfg.TrainConfig(**kw))
    for step in sorted({0, 1, max(warmup - 1, 0), warmup, warmup + 1, 55, 99, 100, 150}):
        assert abs(got(step) - float(ref(step))) < 1e-12, step  # float32 vs float64 arithmetic
    assert got(warmup) == 1e-5 and abs(got(100) - 1e-7) < 1e-15
    if warmup:
        assert got(0) == 0.0 and got(warmup + 1) < 1e-5


@pytest.mark.parametrize("gain", [0.01, 1.0, 37.0])
def test_global_norm_clip_matches_optax(gain):
    """Below the threshold the gradients pass unchanged; above it they are
    scaled by max_norm / norm (not torch's max_norm / (norm + 1e-6))."""
    shapes = [(8, 2), (2, 8), (5,)]
    grads = [gain * _np(10 + i, s) for i, s in enumerate(shapes)]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], optax.EmptyState())
    params = [torch.zeros(s, requires_grad=True) for s in shapes]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = port_trainer.clip_by_global_norm_(params, 1.0)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm([jnp.asarray(g) for g in grads])), rtol=1e-6)
    for p, w, g in zip(params, want, grads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=0)
        if norm.item() < 1.0:
            np.testing.assert_array_equal(p.grad.numpy(), g)


def _compare_loss_and_grads(jax_modules, mods, jax_fn, mel_frames, rng_seed, tol):  # noqa: F811
    tree = jax_adapters(jax_modules.unet, LCFG.target_modules, LCFG.r, 7)
    adapters = lora_from_jax(tree)
    port_batch, jax_batch = _batch(t=mel_frames)
    rng = jax.random.PRNGKey(rng_seed)
    ref_loss, ref_grads = jax_fn(tree, jax_batch, rng)
    draws = jax_draws(rng, (2, mel_frames // 2, 4, 4))
    loss, _ = port_trainer.lora_loss_fn(adapters, mods, port_batch, LCFG.scale, draws=draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=tol)
    got, want = _grads(adapters), dict(_flat(ref_grads))
    assert got.keys() == want.keys()
    top = max(np.abs(g).max() for g in want.values())
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=tol * top, err_msg=key)
    assert top > 0


def test_lora_loss_and_grads_match_jax(jax_modules, mods, jax_loss_and_grad):  # noqa: F811
    """Loss to 1e-5 relative and every adapter gradient to 1e-4 of the
    largest entry, with the JAX draws (plain attention on both sides)."""
    for m in (mods.unet, mods.vae, mods.text_encoder):
        m.requires_grad_(False)
    _compare_loss_and_grads(jax_modules, mods, jax_loss_and_grad, 16, 0, 1e-4)


def test_lora_loss_and_grads_match_jax_through_flash_kernels(jax_modules, mods, monkeypatch):  # noqa: F811
    """The same with 320 level-0 tokens routed through flash attention: the
    Pallas K3-K5 in interpret mode on the JAX side, the autograd Function
    with the kernels' plain versions on the port's. 2e-4 (the streaming
    softmax and its recomputation in the backward round differently)."""
    jfa = importlib.import_module("audioldm_tpu.kernels.flash_attention")
    for name, value in (("_ENABLED", True), ("_FORCE_INTERPRET", True), ("_MIN_TOKENS", 256), ("_flash_jits", {})):
        monkeypatch.setattr(jfa, name, value)
    monkeypatch.setattr(port_fa, "_MIN_TOKENS", 256)
    calls = []
    orig = port_fa._FlashFunction.forward
    monkeypatch.setattr(port_fa._FlashFunction, "forward",
                        staticmethod(lambda ctx, q, k, v, s: calls.append(tuple(q.shape)) or orig(ctx, q, k, v, s)))
    for m in (mods.unet, mods.vae, mods.text_encoder):
        m.requires_grad_(False)
    _compare_loss_and_grads(jax_modules, mods, _jit_loss_and_grad(jax_modules), 160, 1, 2e-4)
    assert calls == [(2, 2, 320, 4)] * 6  # attn1 + attn2 of the level-0 transformers: 1 down + 2 up


def test_three_optimizer_steps_match_jax(jax_modules, mods, jax_loss_and_grad, tmp_path):  # noqa: F811
    """Three steps from the JAX draws: loss per step to 1e-5 relative, the
    gradient norm to 1e-4, and A/B after each step to within 0.02 learning
    rates. Adam's first steps divide the gradient by its own magnitude, so an
    entry whose gradient is near zero moves by up to one learning rate in
    either direction whatever its size: gradients are held tightly (above),
    parameters in units of the learning rate."""
    lr = 1e-3
    jcfg = JaxTrainConfig(learning_rate=lr, max_train_steps=10)
    cfg = tcfg.TrainConfig(learning_rate=lr, max_train_steps=10, checkpointing_steps=100)
    tree = jax.tree.map(jnp.asarray, jax_adapters(jax_modules.unet, LCFG.target_modules, LCFG.r, 8))
    trainer = port_trainer.Trainer(mods, LCFG, cfg, str(tmp_path), device="cpu")
    state = trainer.init_state(lora_from_jax(tree))
    opt = jax_trainer.make_optimizer(jcfg)
    opt_state = opt.init(tree)
    rng = jax.random.PRNGKey(5)
    for step in range(3):
        port_batch, jax_batch = _batch(seed=100 + step)
        rng, key = jax.random.split(rng)
        ref_loss, grads = jax_loss_and_grad(tree, jax_batch, key)
        updates, opt_state = opt.update(grads, opt_state, tree)
        tree = optax.apply_updates(tree, updates)
        state, metrics = trainer.step_fn(state, port_batch, draws=jax_draws(key, (2, 8, 4, 4)))
        assert state.step == step + 1
        np.testing.assert_allclose(metrics["loss"].item(), float(ref_loss), rtol=1e-5)
        np.testing.assert_allclose(metrics["grad_norm"].item(), float(optax.global_norm(grads)), rtol=1e-4)
        got, want = dict(_flat(lora_to_numpy(state.lora))), dict(_flat(tree))
        for key_ in want:
            np.testing.assert_allclose(got[key_], want[key_], atol=0.02 * lr, err_msg=f"step {step} {key_}")


def _fresh(mods, tmp_path, **cfg):
    train_cfg = tcfg.TrainConfig(**{"learning_rate": 1e-3, "max_train_steps": 10, "checkpointing_steps": 100, **cfg})
    trainer = port_trainer.Trainer(mods, LCFG, train_cfg, str(tmp_path), device="cpu")
    lora = init_lora(mods.unet, LCFG, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in lora.b.values():  # nonzero B, so that A gets gradients too
            p.copy_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(2)))
    return trainer, trainer.init_state(lora)


def _fixed_draws(b, accum=None):
    gen = torch.Generator().manual_seed(9)
    lead = (accum, b // accum) if accum else (b,)
    return {"latent_eps": torch.randn(*lead, 4, 8, 4, generator=gen), "noise": torch.randn(*lead, 4, 8, 4, generator=gen),
            "t": torch.randint(0, 1000, lead, generator=gen)}


def test_grad_accumulation_equals_the_big_batch(mods, tmp_path):
    """accum=2 over [2, 2, ...] equals one batch of 4 when both see the same
    draws: the loss and the updated adapters to 1e-6. (The big-batch MSE is
    the mean of the two micro-batch means.)"""
    batch, _ = _batch(b=4)
    tr1, s1 = _fresh(mods, tmp_path / "a")
    s1, m1 = tr1.step_fn(s1, batch, draws=_fixed_draws(4))
    tr2, s2 = _fresh(copy.deepcopy(mods), tmp_path / "b", gradient_accumulation_steps=2)
    s2, m2 = tr2.step_fn(s2, port_trainer.to_accum_layout(batch, 2), draws=_fixed_draws(4, accum=2))
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(), rtol=1e-6)
    np.testing.assert_allclose(m2["grad_norm"].item(), m1["grad_norm"].item(), rtol=1e-4)
    for a, b in zip(s1.lora.parameters(), s2.lora.parameters()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_to_accum_layout():
    batch = {"x": np.arange(12).reshape(6, 2), "s": 3.0}
    out = port_trainer.to_accum_layout(batch, 3)
    assert out["x"].shape == (3, 2, 2) and out["s"] == 3.0
    np.testing.assert_array_equal(out["x"][0], [[0, 1], [2, 3]])
    with pytest.raises(ValueError):
        port_trainer.to_accum_layout({"x": np.zeros((5, 2))}, 2)


def test_remat_equals_standard(mods, tmp_path):
    batch, _ = _batch()
    _, state = _fresh(mods, tmp_path)
    grads = []
    for remat in (False, True):
        for p in state.lora.parameters():
            p.grad = None
        loss, _ = port_trainer.lora_loss_fn(state.lora, mods, batch, LCFG.scale, remat=remat, draws=_fixed_draws(2))
        loss.backward()
        grads.append([p.grad.clone() for p in state.lora.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)
        assert a.abs().max() > 0


def test_only_adapters_get_gradients_and_base_weights_stay(mods, tmp_path):
    batch, _ = _batch()
    trainer, state = _fresh(mods, tmp_path)
    models = (mods.unet, mods.vae, mods.text_encoder, mods.vocoder)
    assert not any(p.requires_grad for m in models for p in m.parameters())
    base = [p.detach().clone() for m in models for p in m.parameters()]
    before = [p.detach().clone() for p in state.lora.parameters()]
    state, metrics = trainer.step_fn(state, batch, generator=torch.Generator().manual_seed(0))
    assert np.isfinite(metrics["loss"].item()) and metrics["grad_norm"].item() > 0
    assert all(p.grad is None for m in models for p in m.parameters())
    assert all(torch.equal(p, q) for p, q in zip((p for m in models for p in m.parameters()), base))
    assert all(not torch.equal(p, q) for p, q in zip(state.lora.parameters(), before))
    # a generator gives the same draws again; another seed gives others
    l0 = port_trainer.lora_loss_fn(state.lora, mods, batch, 1.0, generator=torch.Generator().manual_seed(4))[0]
    l1 = port_trainer.lora_loss_fn(state.lora, mods, batch, 1.0, generator=torch.Generator().manual_seed(4))[0]
    l2 = port_trainer.lora_loss_fn(state.lora, mods, batch, 1.0, generator=torch.Generator().manual_seed(5))[0]
    assert l0.item() == l1.item() != l2.item()


def test_bf16_trainer_loss_near_fp32(mods, tmp_path):
    """Trainer(dtype=bf16) casts every float of the frozen UNet, VAE and
    text tower to bf16, norms included (the JAX trainer's rule), leaves the
    vocoder, the adapters and the optimizer state fp32; the loss stays
    within 5% of the fp32 trainer's (the JAX package's own criterion)."""
    batch, _ = _batch(b=4)
    tr32, s32 = _fresh(mods, tmp_path / "fp32")
    _, m32 = tr32.step_fn(s32, batch, draws=_fixed_draws(4))
    mods16 = copy.deepcopy(mods)
    _, s16 = _fresh(mods16, tmp_path / "bf16")
    tr16 = port_trainer.Trainer(mods16, LCFG, tr32.train_cfg, str(tmp_path / "bf16"), dtype=torch.bfloat16, device="cpu")
    assert mods16.unet.conv_in.weight.dtype == mods16.vae.encoder.conv_in.weight.dtype == torch.bfloat16
    for m in (mods16.unet, mods16.vae, mods16.text_encoder):
        assert all(p.dtype == torch.bfloat16 for p in m.parameters())
    assert mods16.unet.conv_norm_out.weight.dtype == mods16.text_encoder.text_model.embeddings.LayerNorm.weight.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in mods16.vocoder.parameters())
    assert mods.unet.conv_in.weight.dtype == torch.float32
    s16 = tr16.init_state(s16.lora)
    s16, m16 = tr16.step_fn(s16, batch, draws=_fixed_draws(4))
    assert all(p.dtype == torch.float32 for p in s16.lora.parameters())
    assert all(v.dtype == torch.float32 for st in s16.optimizer.state_dict()["state"].values() for v in st.values())
    l32, l16 = m32["loss"].item(), m16["loss"].item()
    assert np.isfinite(l16) and abs(l16 - l32) / abs(l32) < 0.05


def test_bf16_trainer_step_matches_the_jax_bf16_trainer(jax_modules, mods, tmp_path):  # noqa: F811
    """One tiny step of ``Trainer(dtype=bfloat16)`` against the JAX
    ``Trainer(dtype=bfloat16)`` on the same weights, adapters, batch and
    draws (the JAX loss's own, its posterior eps drawn in bf16 as the JAX
    VAE draws it). The port casts what the JAX trainer casts: every fp32
    float of the frozen UNet, VAE and text tower, norms included. Loss and
    the step's gradient norm to 2e-2 relative, every adapter gradient to
    5e-2 of the largest entry: both run the same bf16 graph, but bf16
    rounds after every op that XLA and PyTorch fuse or order differently
    (one bf16 ulp is 2^-8 = 3.9e-3 relative, and the UNet chains dozens)."""
    jm = jax_modules._replace(**{n: jax.tree.map(jnp.asarray, getattr(jax_modules, n))
                                 for n in ("unet", "vae", "text_encoder", "vocoder")})
    jcfg = JaxTrainConfig(learning_rate=1e-3, max_train_steps=10)
    jt = jax_trainer.Trainer(jm, JLCFG, jcfg, str(tmp_path / "jax"), dtype=jnp.bfloat16)
    tree = jax.tree.map(jnp.asarray, jax_adapters(jax_modules.unet, LCFG.target_modules, LCFG.r, 7))
    port_batch, jax_batch = _batch()
    rng = jax.random.PRNGKey(3)
    _, jmetrics = jt.step_fn(jax_trainer.init_train_state(tree, jt.optimizer), jax_batch, rng)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda lora: jax_trainer.lora_loss_fn(lora, jt.modules, jax_batch, rng, JLCFG.scale, jnp.bfloat16)[0])(tree)

    cfg = tcfg.TrainConfig(learning_rate=1e-3, max_train_steps=10, checkpointing_steps=100)
    trainer = port_trainer.Trainer(mods, LCFG, cfg, str(tmp_path / "port"), dtype=torch.bfloat16, device="cpu")
    for name in ("unet", "vae", "text_encoder"):  # as the JAX trainer: every fp32 leaf in bf16
        jax_dtypes = {str(x.dtype) for x in jax.tree.leaves(getattr(jt.modules, name)) if jnp.issubdtype(x.dtype, jnp.floating)}
        port_dtypes = {t.dtype for t in (*getattr(mods, name).parameters(), *getattr(mods, name).buffers()) if t.is_floating_point()}
        assert jax_dtypes == {"bfloat16"} and port_dtypes == {torch.bfloat16}, name
    assert mods.unet.conv_norm_out.weight.dtype == mods.text_encoder.text_model.embeddings.LayerNorm.weight.dtype == torch.bfloat16
    k_latent, k_noise, k_t = jax.random.split(rng, 3)
    draws = jax_draws(rng, (2, 8, 4, 4))
    eps = jax.random.normal(k_latent, (2, 8, 4, 4), jnp.bfloat16).astype(jnp.float32)
    draws["latent_eps"] = torch.from_numpy(np.asarray(eps).transpose(0, 3, 1, 2).copy())
    state = trainer.init_state(lora_from_jax(tree))
    state, metrics = trainer.step_fn(state, port_batch, draws=draws)
    assert all(p.dtype == torch.float32 for p in state.lora.parameters())
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=5e-3)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(jmetrics["grad_norm"]), rtol=2e-2)

    adapters = lora_from_jax(tree)
    loss, _ = port_trainer.lora_loss_fn(adapters, mods, port_batch, LCFG.scale, torch.bfloat16, draws=draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=5e-3)
    got, want = _grads(adapters), dict(_flat(ref_grads))
    assert got.keys() == want.keys()
    top = max(np.abs(g).max() for g in want.values())
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key], np.float32), atol=5e-2 * top, rtol=0, err_msg=key)
    assert top > 0


def test_save_restore_round_trip_keeps_three(mods, tmp_path):
    batch, _ = _batch()
    trainer, state = _fresh(mods, tmp_path, checkpointing_steps=1)
    gen = torch.Generator().manual_seed(0)
    state, _ = trainer.fit(state, iter([batch] * 5), gen, max_steps=5)
    assert state.step == 5
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["step-3.pt", "step-4.pt", "step-5.pt"]
    assert all((tmp_path / f"checkpoint-{n}" / "model.safetensors").exists() for n in range(1, 6))
    other, fresh = _fresh(copy.deepcopy(mods), tmp_path)
    restored = other.restore(fresh)
    assert restored.step == 5
    for a, b in zip(restored.lora.parameters(), state.lora.parameters()):
        assert torch.equal(a, b)
    sa, sb = restored.optimizer.state_dict()["state"], state.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k]["exp_avg_sq"], sb[k]["exp_avg_sq"]) for k in sa)
    # both continue alike
    n1, _ = trainer.step_fn(state, batch, draws=_fixed_draws(2))
    n2, _ = other.step_fn(restored, batch, draws=_fixed_draws(2))
    for a, b in zip(n1.lora.parameters(), n2.lora.parameters()):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)
    empty, untouched = _fresh(copy.deepcopy(mods), tmp_path / "none")
    assert empty.restore(untouched) is untouched


def test_peft_checkpoint_matches_jax_export_and_imports_back(mods, tmp_path):
    trainer, state = _fresh(mods, tmp_path)
    trainer.save(state)
    sd = read_safetensors(str(tmp_path / "checkpoint-0" / "model.safetensors"))
    want = jax_lora.export_peft_state_dict(lora_to_numpy(state.lora))
    assert sd.keys() == want.keys() and len(sd) == 32
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), want[k])
    back, rank = import_peft_state_dict(sd)
    assert rank == 2
    for path, a, b in state.lora.items():
        assert torch.equal(back.get(path)[0], a) and torch.equal(back.get(path)[1], b)


def test_fit_logs_the_applied_lr_validates_and_counts_epochs(mods, tmp_path):
    batch, _ = _batch()
    trainer, state = _fresh(mods, tmp_path, lr_warmup_steps=2, max_train_steps=8)
    records, calls = [], []

    class Logger:
        def log(self, metrics, step):
            records.append((step, metrics))

    trainer.logger = Logger()

    def batches():
        while True:
            yield batch

    state, metrics = trainer.fit(state, batches(), steps_per_epoch=2, num_epochs=3, validate_every_epochs=1,
                                 validate_fn=lambda st, step: calls.append(step) or {"val": 1.0}, log_every=2,
                                 profile_dir=str(tmp_path / "prof"), profile_steps=(1, 2))
    assert state.step == 6 and calls == [2, 4, 6]  # min(3 epochs x 2 steps, max_train_steps)
    logged = [(s, m) for s, m in records if "lr" in m]
    assert [s for s, _ in logged] == [2, 4, 6]
    sched = port_trainer.make_lr_schedule(trainer.train_cfg)
    for step, m in logged:
        assert m["lr"] == sched(step - 1) and m["epoch"] == (step - 1) // 2
        assert np.isfinite(m["train_loss"]) and np.isfinite(m["total_train_loss"]) and m["grad_norm"] > 0
    assert logged[0][1]["lr"] == sched(1) == 0.5e-3  # step 2 ran at count 1, mid warm-up
    assert [m for s, m in records if "val" in m] == [{"val": 1.0}] * 3
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]  # the profiled window, steps [1, 2): step 2
    assert sorted(e["name"] for e in spans if e["name"] in ("train.fetch", "train.step", "train.log")) == [
        "train.fetch", "train.log", "train.step"]
    assert {e["args"]["key"] for e in spans if e["name"].startswith("train.")} == {2}
    # the iterator running dry ends the loop
    state, _ = trainer.fit(state, iter([batch]), max_steps=8)
    assert state.step == 7


def test_trainer_needs_a_gpu_unless_asked_for_cpu(mods, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        port_trainer.Trainer(mods, LCFG, tcfg.TrainConfig(), str(tmp_path))
    assert mods.device.type == "cpu"
    port_trainer.Trainer(mods, LCFG, tcfg.TrainConfig(), str(tmp_path), device="cpu")


def test_train_config_defaults_match_jax():
    import dataclasses

    for ours, theirs in ((tcfg.TrainConfig(), JaxTrainConfig()), (tcfg.LoRAConfig(), JaxLoRAConfig())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
