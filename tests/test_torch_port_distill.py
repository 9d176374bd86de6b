"""The port's LCM-LoRA consistency distillation (audioldm_tpu_torch/train/
distill.py) against the JAX package's, at tiny widths on the CPU.

torch cannot reproduce ``jax.random``, so each test makes the four draws of
the JAX ``distill_loss_fn`` (posterior eps, noise, grid index, per-row w)
from the JAX key split ``jax.random.split(rng, 4)`` and hands them to the
port as ``draws``. Weights, adapters and batches come from numpy seeds. The
grid index is an index into ``ddim_training_grid``; the loss cases use the
first key whose draw has a row at index 0, where the target's consistency
output is the identity. Training-path tolerances are those of
tests/test_torch_port_train.py: loss to 1e-5 relative, gradients to 1e-4 of
the largest entry (2e-4 through the flash kernels' plain versions).
"""

import copy
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioldm_tpu.config import LoRAConfig as JaxLoRAConfig
from audioldm_tpu.config import TrainConfig as JaxTrainConfig
from audioldm_tpu.train import distill as jax_distill
from audioldm_tpu.train import trainer as jax_trainer
from audioldm_tpu_torch import config as tcfg
from audioldm_tpu_torch.ckpt import lora_from_jax, lora_to_numpy
from audioldm_tpu_torch.kernels import flash_attention as port_fa
from audioldm_tpu_torch.lora import init_lora
from audioldm_tpu_torch.train import distill as port_distill
from test_torch_port_lora import _flat, jax_adapters
from test_torch_port_pipeline import jax_modules, port_modules  # noqa: F401 (fixture)
from tests.test_serve import DummyTokenizer

LCFG, JLCFG = tcfg.LoRAConfig(), JaxLoRAConfig()
N_DDIM = 50


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: at these tiny sizes a pool only waits for its
    members, and slows by orders of magnitude when test processes share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(b=2, t=16, f=8, seed=0):
    """(port batch NCHW, JAX batch NHWC) of the same numbers, with the
    tokenized empty negative prompt."""
    mel = np.random.default_rng(seed).standard_normal((b, t, f, 1)).astype(np.float32)
    ids = np.array([[0, 45, 77, 12, 2, 1], [0, 9, 2, 1, 1, 1]] * b, np.int32)[:b]
    u_ids = np.array([[0, 2, 1, 1, 1, 1]], np.int32)
    port = {"log_mel_spec": mel.transpose(0, 3, 1, 2), "input_ids": ids, "attention_mask": (ids != 1).astype(np.int32),
            "uncond_ids": u_ids, "uncond_mask": (u_ids != 1).astype(np.int32)}
    jx = {k: jnp.asarray(v) for k, v in port.items()}
    jx["log_mel_spec"] = jnp.asarray(mel)
    return port, jx


def jax_distill_draws(rng, latent_shape_nhwc, w=2.5, eps_dtype=jnp.float32):
    """The draws of the JAX ``distill_loss_fn`` for ``rng`` as the port's
    ``draws`` (NCHW); the posterior eps in ``eps_dtype``, as the JAX VAE
    draws it in its mean's dtype."""
    k_latent, k_noise, k_idx, k_w = jax.random.split(rng, 4)
    nchw = lambda x: torch.from_numpy(np.asarray(x, np.float32).transpose(0, 3, 1, 2).copy())
    b = latent_shape_nhwc[0]
    out = {"latent_eps": nchw(jax.random.normal(k_latent, latent_shape_nhwc, eps_dtype).astype(jnp.float32)),
           "noise": nchw(jax.random.normal(k_noise, latent_shape_nhwc, jnp.float32)),
           "idx": torch.from_numpy(np.asarray(jax.random.randint(k_idx, (b,), 0, N_DDIM)).astype(np.int64))}
    if isinstance(w, tuple):
        out["w"] = torch.from_numpy(np.array(jax.random.uniform(k_w, (b,), jnp.float32, w[0], w[1])))
    return out


def key_with_idx_zero(b=2):
    """The first ``PRNGKey(s)`` whose grid-index draw has a row at 0."""
    for s in range(1000):
        rng = jax.random.PRNGKey(s)
        if 0 in np.asarray(jax.random.randint(jax.random.split(rng, 4)[2], (b,), 0, N_DDIM)):
            return rng
    raise AssertionError("no key below 1000 draws index 0")


def _jax_mods(jm, dtype=jnp.float32):
    """The fixture's numpy weights as jax arrays (traced ids index them),
    the UNet and the VAE cast to ``dtype`` as ``cli distill`` casts them."""
    jm = jm._replace(**{n: jax.tree.map(jnp.asarray, getattr(jm, n)) for n in ("unet", "vae", "text_encoder", "vocoder")})
    if dtype != jnp.float32:
        bf = lambda t: jax.tree.map(lambda x: x.astype(dtype), t)
        jm = jm._replace(unet=bf(jm.unet), vae=bf(jm.vae))
    return jm


def _grads(adapters):
    return {f"{p}.{n}": g.grad.numpy() for p, a, b in adapters.items() for n, g in (("a", a), ("b", b))}


@pytest.fixture
def mods(jax_modules):  # noqa: F811
    return port_distill.distill_modules(port_modules(jax_modules))


def _adapters(jax_modules, seed):  # noqa: F811
    """(JAX tree, port student, port EMA target): the target a different
    adapter, so that the target call is felt."""
    tree = jax.tree.map(jnp.asarray, jax_adapters(jax_modules.unet, LCFG.target_modules, LCFG.r, seed))
    target = jax.tree.map(jnp.asarray, jax_adapters(jax_modules.unet, LCFG.target_modules, LCFG.r, seed + 50))
    return tree, target, lora_from_jax(tree), lora_from_jax(target).requires_grad_(False)


def _hold_loss_and_grads(jax_modules, mods, rng, tol, frames=16, **kw):  # noqa: F811
    jm = _jax_mods(jax_modules)
    tree, target, lora, ema = _adapters(jax_modules, 7)
    port_batch, jax_batch = _batch(t=frames)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda l: jax_distill.distill_loss_fn(l, target, jm, jax_batch, rng, JLCFG.scale, **kw)[0]))(tree)
    draws = jax_distill_draws(rng, (2, frames // 2, 4, 4), kw.get("w", 2.5))
    loss, _ = port_distill.distill_loss_fn(lora, ema, mods, port_batch, LCFG.scale, draws=draws, **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    got, want = _grads(lora), dict(_flat(ref_grads))
    assert got.keys() == want.keys()
    top = max(np.abs(g).max() for g in want.values())
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=tol * top, err_msg=key)
    assert top > 0 and all(p.grad is None for p in ema.parameters())
    return draws


@pytest.mark.parametrize("loss_type,w", [("huber", 2.5), ("l2", (2.0, 3.0))])
def test_distill_loss_and_grads_match_jax(jax_modules, mods, loss_type, w):  # noqa: F811
    """Plain attention on both sides, from a key with a row at grid index 0."""
    draws = _hold_loss_and_grads(jax_modules, mods, key_with_idx_zero(), 1e-4, loss_type=loss_type, w=w)
    assert 0 in draws["idx"].tolist()
    if "w" in draws:
        assert draws["w"].min() >= 2.0 and draws["w"].max() < 3.0 and draws["w"][0] != draws["w"][1]


def test_distill_loss_and_grads_match_jax_through_flash_kernels(jax_modules, mods, monkeypatch):  # noqa: F811
    """320 level-0 tokens routed through flash attention: the Pallas
    kernels in interpret mode on the JAX side; on the port's, the student
    through the autograd Function (K3-K5's plain versions), the teacher's
    two calls and the target's through K1's plain version. 2e-4, as the
    trainer's flash case (the streaming softmax and its recomputation in
    the backward round differently)."""
    jfa = importlib.import_module("audioldm_tpu.kernels.flash_attention")
    for name, value in (("_ENABLED", True), ("_FORCE_INTERPRET", True), ("_MIN_TOKENS", 256), ("_flash_jits", {})):
        monkeypatch.setattr(jfa, name, value)
    monkeypatch.setattr(port_fa, "_MIN_TOKENS", 256)
    routes = _count_routes(monkeypatch)
    _hold_loss_and_grads(jax_modules, mods, key_with_idx_zero(), 2e-4, frames=160, w=(2.0, 3.0))
    # attn1 + attn2 of the level-0 transformers (1 down + 2 up) a UNet call
    assert routes == {"function": [(2, 2, 320, 4)] * 6, "no_grad": [(2, 2, 320, 4)] * 18}


def _count_routes(monkeypatch) -> dict:
    """Record the shape of every level-0 attention call by the route it took
    on the CPU: the autograd Function (K3-K5 on the card) or the no-grad
    plain forward (K1 on the card)."""
    routes = {"function": [], "no_grad": []}
    fwd, plain = port_fa._FlashFunction.forward, port_fa.flash_plain
    monkeypatch.setattr(port_fa._FlashFunction, "forward",
                        staticmethod(lambda ctx, q, k, v, s: routes["function"].append(tuple(q.shape)) or fwd(ctx, q, k, v, s)))
    monkeypatch.setattr(port_fa, "flash_plain", lambda q, k, v: routes["no_grad"].append(tuple(q.shape)) or plain(q, k, v))
    return routes


def _fresh(mods, **cfg):
    student = init_lora(mods.unet, LCFG, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in student.b.values():  # nonzero B, so that A gets gradients too
            p.copy_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(2)))
    return port_distill.init_distill_state(student, tcfg.TrainConfig(**{"learning_rate": 1e-3, "max_train_steps": 10, **cfg}))


def test_routes_by_grad_and_only_the_student_gets_gradients(mods, monkeypatch):
    """The student's calls go through the autograd Function, the teacher's
    and the target's through the no-grad forward (counted by route on the
    CPU, as the launch counters count them on the card); the backward
    reaches the student's A and B only: no base weight and no EMA entry has
    a gradient or moves, and the EMA is d e + (1 - d) p of the updated
    student."""
    monkeypatch.setattr(port_fa, "_MIN_TOKENS", 256)
    routes = _count_routes(monkeypatch)
    state = _fresh(mods)
    models = (mods.unet, mods.vae, mods.text_encoder, mods.vocoder)
    assert not any(p.requires_grad for m in models for p in m.parameters())
    assert not any(p.requires_grad for p in state.ema_lora.parameters())
    base = [p.detach().clone() for m in models for p in m.parameters()]
    ema0 = [p.detach().clone() for p in state.ema_lora.parameters()]
    before = [p.detach().clone() for p in state.lora.parameters()]
    batch, _ = _batch(t=160)
    state, metrics = port_distill.distill_step(state, mods, batch, LCFG, ema_decay=0.9, generator=torch.Generator().manual_seed(0))
    assert routes == {"function": [(2, 2, 320, 4)] * 6, "no_grad": [(2, 2, 320, 4)] * 18}
    assert state.step == 1 and np.isfinite(metrics["loss"].item()) and metrics["grad_norm"].item() > 0
    assert all(p.grad is None for m in models for p in m.parameters())
    assert all(p.grad is None for p in state.ema_lora.parameters())
    assert all(torch.equal(p, q) for p, q in zip((p for m in models for p in m.parameters()), base))
    assert all(not torch.equal(p, q) for p, q in zip(state.lora.parameters(), before))
    for e, e0, p in zip(state.ema_lora.parameters(), ema0, state.lora.parameters()):
        torch.testing.assert_close(e, 0.9 * e0 + 0.1 * p, atol=1e-7, rtol=1e-6)
    # a generator gives the same draws again; another seed gives others
    loss = lambda s: port_distill.distill_loss_fn(state.lora, state.ema_lora, mods, batch, 1.0,
                                                  generator=torch.Generator().manual_seed(s))[0].item()
    assert loss(4) == loss(4) != loss(5)


def test_remat_equals_standard(mods):
    batch, _ = _batch()
    state = _fresh(mods)
    draws = jax_distill_draws(jax.random.PRNGKey(2), (2, 8, 4, 4), (2.0, 3.0))
    grads = []
    for remat in (False, True):
        for p in state.lora.parameters():
            p.grad = None
        loss, _ = port_distill.distill_loss_fn(state.lora, state.ema_lora, mods, batch, LCFG.scale, w=(2.0, 3.0),
                                               remat=remat, draws=draws)
        loss.backward()
        grads.append((loss.item(), [p.grad.clone() for p in state.lora.parameters()]))
    assert grads[0][0] == grads[1][0]
    for a, b in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)
        assert a.abs().max() > 0


def test_unknown_loss_type_raises(mods):
    state = _fresh(mods)
    with pytest.raises(ValueError, match="unknown loss_type"):
        port_distill.distill_loss_fn(state.lora, state.ema_lora, mods, _batch()[0], 1.0, loss_type="l1",
                                     generator=torch.Generator().manual_seed(0))


def _jax_step(jax_modules, jcfg, dtype=jnp.float32, **kw):  # noqa: F811
    opt = jax_trainer.make_optimizer(jcfg)
    return opt, jax_distill.make_distill_step(_jax_mods(jax_modules, dtype), opt, JLCFG, dtype=dtype, **kw)


def test_three_distill_steps_match_jax(jax_modules, mods):  # noqa: F811
    """Three ``distill_step``s against the JAX ``make_distill_step`` from the
    same adapters, batches and draws: the loss a step to 1e-5 relative, the
    gradient norm to 1e-4, and the student and the EMA adapters after each
    step within 0.02 learning rates (Adam's first steps move an entry whose
    gradient is near 0 by up to one learning rate either way, see
    tests/test_torch_port_train.py)."""
    lr, d = 1e-3, 0.9
    jcfg = JaxTrainConfig(learning_rate=lr, max_train_steps=10)
    opt, step_fn = _jax_step(jax_modules, jcfg, w=(2.0, 3.0), ema_decay=d)
    tree, _, lora, _ = _adapters(jax_modules, 8)
    jstate = jax_distill.init_distill_state(tree, opt)
    state = port_distill.init_distill_state(lora, tcfg.TrainConfig(learning_rate=lr, max_train_steps=10))
    rng = jax.random.PRNGKey(5)
    for step in range(3):
        port_batch, jax_batch = _batch(seed=100 + step)
        rng, key = jax.random.split(rng)
        jstate, jm = step_fn(jstate, jax_batch, key)
        state, metrics = port_distill.distill_step(state, mods, port_batch, LCFG, w=(2.0, 3.0), ema_decay=d,
                                                   draws=jax_distill_draws(key, (2, 8, 4, 4), (2.0, 3.0)))
        assert state.step == step + 1 == int(jstate.step)
        np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(metrics["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
        for ours, theirs in ((state.lora, jstate.lora), (state.ema_lora, jstate.ema_lora)):
            got, want = dict(_flat(lora_to_numpy(ours))), dict(_flat(theirs))
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(got[k], want[k], atol=0.02 * lr, err_msg=f"step {step} {k}")


def _adam_mu(opt_state):
    """The first moment of the JAX optimizer's Adam state."""
    if hasattr(opt_state, "mu"):
        return opt_state.mu
    for part in opt_state if isinstance(opt_state, tuple) else ():
        found = _adam_mu(part)
        if found is not None:
            return found
    return None


def test_bf16_distill_step_matches_the_jax_bf16_step(jax_modules, mods):  # noqa: F811
    """One bf16 step, the UNet and the VAE cast whole to bf16 as ``cli
    distill`` casts them (the text encoder and the adapters fp32), against
    the JAX bf16 step from the same draws, its posterior eps drawn in bf16.
    Both run the same bf16 graph, but bf16 rounds after every op that XLA
    and PyTorch fuse or order differently (one ulp is 3.9e-3 relative), and
    the teacher's step amplifies an eps error by 1/sqrt(alphas_cumprod[t])
    (up to 15x) and by 1 + 2w: loss and gradient norm to 2e-2 relative
    (read: 8e-3 and 1.0e-2), and Adam's first moments (the clipped
    gradients times 1 - beta1) no farther from the JAX step's than 1.5
    times the distance that bf16 rounding puts between the JAX bf16 step
    and the fp32 step on the same draws (read: 0.14 of the largest entry
    against 0.19; the port's fp32 step stands for JAX's, which the fp32
    tests above hold it to). Adam's first step moves each entry by about one learning rate
    times the sign of its gradient: the student and the EMA adapters are
    held within 0.05 learning rates where the first moment stands clear of
    that distance, and within 2.05 learning rates everywhere."""
    lr = 1e-3
    jcfg = JaxTrainConfig(learning_rate=lr, max_train_steps=10)
    opt, step_fn = _jax_step(jax_modules, jcfg, dtype=jnp.bfloat16)
    rng = jax.random.PRNGKey(3)
    port_batch, jax_batch = _batch()
    tree, _, _, _ = _adapters(jax_modules, 9)
    jstate, jm = step_fn(jax_distill.init_distill_state(tree, opt), jax_batch, rng)
    mods16 = port_distill.distill_modules(copy.deepcopy(mods), torch.bfloat16)
    for m in (mods16.unet, mods16.vae):
        assert {t.dtype for t in (*m.parameters(), *m.buffers()) if t.is_floating_point()} == {torch.bfloat16}
    for m in (mods16.text_encoder, mods16.vocoder):
        assert {p.dtype for p in m.parameters()} == {torch.float32}

    def port_step(modules, dtype):
        state = port_distill.init_distill_state(_adapters(jax_modules, 9)[2], tcfg.TrainConfig(learning_rate=lr, max_train_steps=10))
        state, metrics = port_distill.distill_step(state, modules, port_batch, LCFG, dtype,
                                                   draws=jax_distill_draws(rng, (2, 8, 4, 4), eps_dtype=jnp.bfloat16))
        adam = state.optimizer.adamw.state
        mu = {f"{p}.{n}": adam[t]["exp_avg"].numpy() for p, a, b in state.lora.items() for n, t in (("a", a), ("b", b))}
        return state, metrics, mu

    state, metrics, mu16 = port_step(mods16, torch.bfloat16)
    _, _, mu32 = port_step(mods, torch.float32)
    assert all(p.dtype == torch.float32 for p in (*state.lora.parameters(), *state.ema_lora.parameters()))
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]), rtol=2e-2)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(jm["grad_norm"]), rtol=2e-2)
    mu_jax = dict(_flat(_adam_mu(jstate.opt_state)))
    assert mu16.keys() == mu_jax.keys() == mu32.keys()
    gap = lambda x, y: max(np.abs(x[k] - y[k]).max() for k in mu_jax)
    rounding = gap(mu_jax, mu32)
    assert 0 < gap(mu16, mu_jax) <= 1.5 * rounding, (gap(mu16, mu_jax), rounding)
    for ours, theirs in ((state.lora, jstate.lora), (state.ema_lora, jstate.ema_lora)):
        got, want = dict(_flat(lora_to_numpy(ours))), dict(_flat(theirs))
        for k in want:
            diff = np.abs(got[k] - want[k])
            settled = np.abs(mu_jax[k]) > 1.5 * rounding
            assert diff.max() <= 2.05 * lr and diff[settled].max(initial=0.0) <= 0.05 * lr, (k, diff.max())


def _adam_mu(opt_state):
    """The first moment of the JAX optimizer's Adam state."""
    if hasattr(opt_state, "mu"):
        return opt_state.mu
    for part in opt_state if isinstance(opt_state, tuple) else ():
        found = _adam_mu(part)
        if found is not None:
            return found
    return None


def test_add_uncond_tokens_matches_jax():
    tok = DummyTokenizer()
    batch = {"input_ids": np.zeros((2, 6), np.int32), "log_mel_spec": np.zeros((2, 1, 4, 4), np.float32)}
    for neg in ("", "low quality noise"):
        got, want = port_distill.add_uncond_tokens(batch, tok, neg), jax_distill.add_uncond_tokens(batch, tok, neg)
        assert got.keys() == want.keys() == {"input_ids", "log_mel_spec", "uncond_ids", "uncond_mask"}
        for k in ("uncond_ids", "uncond_mask"):
            assert got[k].dtype == want[k].dtype == np.int32 and got[k].shape == (1, 6)
            np.testing.assert_array_equal(got[k], want[k])
        assert got["input_ids"] is batch["input_ids"]
