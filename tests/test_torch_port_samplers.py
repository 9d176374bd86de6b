"""The port's other generation paths (audioldm_tpu_torch: DPM-Solver++, LCM,
eta > 0, limited-interval guidance, MultiDiffusion windows, entry at a later
step, inpainting) against the JAX package, at tiny widths on the CPU.

Inputs are made with numpy from a seed and handed to both packages. Where
the JAX loop draws noise (``jax.random``), the test makes the same draws and
hands them to the port as tensors (``draws=``). The JAX package keeps latents
NHWC, the port NCHW: the tests transpose at the boundary only. Per-function
tolerances are 1e-5 (fp32 scheduler math) or exact (host-side grids); whole
trajectories hold at 2e-3.
"""

import importlib
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioldm_tpu.config import DDIMConfig
from audioldm_tpu.models import dpm_solver as jax_dpm
from audioldm_tpu.models import lcm as jax_lcm
from audioldm_tpu.models import scheduler as jax_sched
from audioldm_tpu.pipeline import generate as jax_generate
from audioldm_tpu_torch import cli
from audioldm_tpu_torch import config as tcfg
from audioldm_tpu_torch.kernels import flash_attention as port_fa
from audioldm_tpu_torch.models import dpm_solver as port_dpm
from audioldm_tpu_torch.models import lcm as port_lcm
from audioldm_tpu_torch.models import scheduler as port_sched
from audioldm_tpu_torch.pipeline import generate as port_gen
from test_torch_port_pipeline import SECONDS, _prompts, checkpoint, jax_modules, port_modules  # noqa: F401  (fixtures)

jax_pg = importlib.import_module("audioldm_tpu.pipeline.generate")
SHAPE = (2, 4, 6, 3)  # NCHW


def _nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32).transpose(0, 3, 1, 2).copy())


def _pair(seed, n=2, shape=SHAPE):
    r = np.random.default_rng(seed)
    return [r.standard_normal(shape).astype(np.float32) for _ in range(n)]


# ---------------------------------------------------------------- scheduler math


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
@pytest.mark.parametrize("t,prev_t", [(981, 961), (21, 1), (1, -19)])
def test_ddim_step_with_eta_matches_jax(prediction_type, t, prev_t):
    """eta = 0.7 with given noise, every prediction type, the last step's
    ``prev_t < 0`` included: 1e-5."""
    cfg = DDIMConfig(prediction_type=prediction_type)
    eps, x, noise = _pair(t, 3)
    ref = jax_sched.ddim_step(jax_sched.make_schedule(cfg), jnp.asarray(eps), jnp.asarray(t), jnp.asarray(prev_t),
                              jnp.asarray(x), eta=0.7, noise=jnp.asarray(noise))
    out = port_sched.ddim_step(port_sched.make_schedule(tcfg.DDIMConfig(prediction_type=prediction_type)),
                               torch.from_numpy(eps), t, prev_t, torch.from_numpy(x), eta=0.7, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="requires noise"):
        port_sched.ddim_step(port_sched.make_schedule(), torch.from_numpy(eps), t, prev_t, torch.from_numpy(x), eta=0.7)


@pytest.mark.parametrize("t", [0, 500, np.array([3, 999])])
def test_add_noise_at_a_scalar_or_per_row_timestep_matches_jax(t):
    x, noise = _pair(5)
    ref = jax_sched.add_noise(jax_sched.make_schedule(), jnp.asarray(x), jnp.asarray(noise), jnp.asarray(t))
    tt = torch.from_numpy(t) if isinstance(t, np.ndarray) else t
    out = port_sched.add_noise(port_sched.make_schedule(), torch.from_numpy(x), torch.from_numpy(noise), tt)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
@pytest.mark.parametrize("t,prev_t,is_first", [(961, 921, True), (521, 481, False), (1, -39, False), (41, 1, False)])
def test_dpm_solver_step_matches_jax(prediction_type, t, prev_t, is_first):
    """First-order and second-order updates, ``prev_t < 0`` reading
    ``final_alpha_cumprod``: new sample, x0 and lambda to 1e-5 (relative
    too: the last step divides by a small sigma)."""
    eps, x, prev_x0 = _pair(t + 7, 3)
    jsch = jax_sched.make_schedule(DDIMConfig(prediction_type=prediction_type))
    psch = port_sched.make_schedule(tcfg.DDIMConfig(prediction_type=prediction_type))
    prev_lambda = float(jax_dpm._coeffs(jsch, jnp.asarray(t + 40))[2]) if not is_first else 0.0
    ref = jax_dpm.dpm_solver_step(jsch, jnp.asarray(eps), jnp.asarray(t), jnp.asarray(prev_t), jnp.asarray(x),
                                  jnp.asarray(prev_x0), jnp.asarray(prev_lambda, jnp.float32), is_first=jnp.asarray(is_first))
    out = port_dpm.dpm_solver_step(psch, torch.from_numpy(eps), t, prev_t, torch.from_numpy(x), torch.from_numpy(prev_x0),
                                   torch.tensor(prev_lambda), is_first=is_first)
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_dpm_solver_guards_a_zero_step_and_a_zero_ratio():
    """``h == 0`` (t == prev_t) and ``r == 0`` (prev_lambda == lambda_t)
    are replaced by 1 as in the JAX package: finite, and equal to it."""
    eps, x, prev_x0 = _pair(1, 3)
    jsch, psch = jax_sched.make_schedule(), port_sched.make_schedule()
    lam = float(jax_dpm._coeffs(jsch, jnp.asarray(500))[2])
    for prev_t, prev_lambda in ((500, lam - 0.1), (460, lam)):
        ref = jax_dpm.dpm_solver_step(jsch, jnp.asarray(eps), jnp.asarray(500), jnp.asarray(prev_t), jnp.asarray(x),
                                      jnp.asarray(prev_x0), jnp.asarray(prev_lambda, jnp.float32), is_first=jnp.asarray(False))
        out = port_dpm.dpm_solver_step(psch, torch.from_numpy(eps), 500, prev_t, torch.from_numpy(x),
                                       torch.from_numpy(prev_x0), torch.tensor(prev_lambda), is_first=False)
        assert torch.isfinite(out[0]).all()
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("t", [999, 19, np.array([999, 259])])
def test_consistency_output_matches_jax(t):
    """Scalar and per-row timesteps: 1e-5."""
    eps, x = _pair(11)
    ref = jax_lcm.consistency_output(jax_sched.make_schedule(), jnp.asarray(eps), jnp.asarray(t), jnp.asarray(x))
    tt = torch.from_numpy(t) if isinstance(t, np.ndarray) else t
    out = port_lcm.consistency_output(port_sched.make_schedule(), torch.from_numpy(eps), tt, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    for got, want in zip(port_lcm.boundary_scalings(tt), jax_lcm.boundary_scalings(jnp.asarray(t))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7, rtol=1e-6)
    c_skip, c_out = port_lcm.boundary_scalings(0)
    assert float(c_skip) == 1.0 and float(c_out) == 0.0  # the identity at t = 0


@pytest.mark.parametrize("steps", [1, 4, 8, 25, 50])
def test_timestep_grids_match_jax_exactly(steps):
    cfg, pcfg = DDIMConfig(), tcfg.DDIMConfig()
    np.testing.assert_array_equal(port_sched.inference_timesteps(pcfg, steps), jax_sched.inference_timesteps(cfg, steps))
    np.testing.assert_array_equal(port_dpm.solver_timesteps(1000, steps), jax_dpm.solver_timesteps(1000, steps))
    np.testing.assert_array_equal(port_lcm.lcm_inference_timesteps(pcfg, steps), jax_lcm.lcm_inference_timesteps(cfg, steps))
    np.testing.assert_array_equal(port_lcm.ddim_training_grid(pcfg, steps), jax_lcm.ddim_training_grid(cfg, steps))
    with pytest.raises(ValueError, match="training grid"):
        port_lcm.lcm_inference_timesteps(pcfg, 51)


# ---------------------------------------------------------------- window geometry


@pytest.mark.parametrize("total,window,stride", [(750, 256, 128), (256, 256, 128), (100, 256, 64), (300, 100, 100), (301, 100, 50), (10, 3, 1)])
def test_window_starts_match_jax_exactly(total, window, stride):
    starts = port_gen.window_starts(total, window, stride)
    assert starts == jax_pg.window_starts(total, window, stride)
    covered = np.zeros(total, bool)
    for s in starts:
        covered[s : s + window] = True
    assert covered.all() and starts[-1] + min(window, total) == total


@pytest.mark.parametrize("seconds,overlap", [(None, 0.5), (0.02, 0.5), (0.02, 0.0), (0.011, 0.9), (10.24, 0.25)])
def test_window_params_match_jax_exactly(jax_modules, seconds, overlap):
    assert port_gen.window_params(port_modules(jax_modules), seconds, overlap) == jax_pg.window_params(jax_modules, seconds, overlap)


@pytest.mark.parametrize("seconds,overlap,match", [(0.0, 0.5, "window_seconds"), (-1.0, 0.5, "window_seconds"),
                                                   (1.0, -0.1, "window_overlap"), (1.0, 0.95, "window_overlap")])
def test_window_params_raise_as_jax_does(jax_modules, seconds, overlap, match):
    with pytest.raises(ValueError, match=match):
        jax_pg.window_params(jax_modules, seconds, overlap)
    with pytest.raises(ValueError, match=match):
        port_gen.window_params(port_modules(jax_modules), seconds, overlap)


# ---------------------------------------------------------------- denoise against JAX


def _embeds(jax_modules, b=1):
    ids, mask, u_ids, u_mask = (jnp.asarray(a) for a in _prompts(b))
    cond = jax_pg.encode_prompt(jax_modules, ids, mask)
    uncond = jnp.broadcast_to(jax_pg.encode_prompt(jax_modules, u_ids, u_mask)[:1], cond.shape)
    return cond, uncond


def _step_draws(rng, steps, shape_nhwc, inpaint=False):
    """The JAX loop's draws, NCHW: step ``idx`` folds ``idx`` into ``rng``
    (and once more 1 for the inpainting projection)."""
    keys = [jax.random.fold_in(rng, i) for i in range(steps)]
    if inpaint:
        keys = [jax.random.fold_in(k, 1) for k in keys]
    return [_nchw(jax.random.normal(k, shape_nhwc, jnp.float32)) for k in keys]


DENOISE_CASES = {
    "dpm++": dict(steps=4, kw=dict(scheduler="dpm++")),
    "lcm": dict(steps=3, kw=dict(scheduler="lcm"), noise=True),
    "eta": dict(steps=3, kw=dict(eta=0.6), noise=True),
    "windows": dict(steps=2, kw=dict(window_frames=32, window_stride=24)),
    "windows_lcm": dict(steps=2, kw=dict(window_frames=48, scheduler="lcm"), noise=True),
    "interval": dict(steps=5, kw=dict(guidance_interval=(0.2, 0.7))),
    "interval_dpm++": dict(steps=5, kw=dict(guidance_interval=(0.0, 0.5), scheduler="dpm++")),
    "start_index": dict(steps=4, kw=dict(start_index=2)),
    "start_index_dpm++": dict(steps=4, kw=dict(start_index=1, scheduler="dpm++")),
    "inpaint": dict(steps=3, kw=dict(start_index=1), noise=True, inpaint=True),
    "inpaint_eta": dict(steps=3, kw=dict(eta=0.4), noise=True, inpaint=True),
}


@pytest.mark.parametrize("case", list(DENOISE_CASES))
def test_denoise_matches_jax(jax_modules, case):
    """Every branch of ``denoise`` at tiny geometry, CFG 2.5, batch 2, fp32,
    the same init latents and the JAX loop's own draws: 2e-3 on the final
    latents of the trajectory."""
    spec = DENOISE_CASES[case]
    steps, kw = spec["steps"], dict(spec["kw"])
    b = 2
    cond, uncond = _embeds(jax_modules, b)
    shape = jax_pg.latent_shape(jax_modules, b, SECONDS)  # NHWC [2, 80, 4, 4]
    r = np.random.default_rng(list(DENOISE_CASES).index(case))
    lat = r.standard_normal(shape).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    jkw, pkw = dict(kw), dict(kw)
    draws = {}
    if spec.get("noise"):
        jkw["rng"] = rng
        draws["step_noise"] = _step_draws(rng, steps, shape)
    if spec.get("inpaint"):
        init = r.standard_normal(shape).astype(np.float32)
        mask = np.zeros((1, shape[1], shape[2], 1), np.float32)
        mask[:, shape[1] // 4 : shape[1] // 2] = 1.0
        jkw.update(inpaint_mask=jnp.asarray(mask), init_latents=jnp.asarray(init))
        pkw.update(inpaint_mask=_nchw(mask), init_latents=_nchw(init))
        draws["inpaint_noise"] = _step_draws(rng, steps, shape, inpaint=True)
    ref = jax_pg.denoise(jax_modules, jnp.asarray(lat), cond, uncond, steps, 2.5, **jkw)
    mods = port_modules(jax_modules)
    out = port_gen.denoise(mods, _nchw(lat), torch.from_numpy(np.asarray(cond)), torch.from_numpy(np.asarray(uncond)),
                           steps, 2.5, draws=draws or None, **pkw)
    assert out.shape == (b, shape[3], shape[1], shape[2])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref).transpose(0, 3, 1, 2), atol=2e-3)
    if spec.get("inpaint"):  # after the last step the kept region is the clean init
        keep = torch.from_numpy(mask == 0).permute(0, 3, 1, 2).expand_as(out)
        assert torch.equal(out[keep], pkw["init_latents"][keep])


def test_denoise_draws_from_a_generator_reproducibly(jax_modules):
    """Without ``draws`` the loop's noise comes from the generator: the same
    seed gives the same latents, another seed other latents."""
    mods = port_modules(jax_modules)
    cond = torch.from_numpy(np.asarray(_embeds(jax_modules)[0]))
    lat = port_gen.init_noise(mods, 0, 1, SECONDS)
    run = lambda seed: port_gen.denoise(mods, lat, cond, cond, 2, 2.5, eta=0.8, generator=port_gen.loop_generator(seed))
    first = run(1)
    assert torch.equal(first, run(1)) and not torch.equal(first, run(2))
    lcm = lambda seed: port_gen.denoise(mods, lat, cond, None, 2, 1.0, scheduler="lcm", generator=port_gen.loop_generator(seed))
    first = lcm(1)
    assert torch.equal(first, lcm(1)) and not torch.equal(first, lcm(2))


@pytest.mark.parametrize("kw,match", [
    (dict(scheduler="euler"), "unknown scheduler"),
    (dict(scheduler="lcm"), "lcm sampling requires"),
    (dict(eta=0.5), "eta > 0 requires"),
    (dict(scheduler="lcm", start_index=1, generator=True), "start_index"),
    (dict(start_index=3), "start_index 3 outside"),
    (dict(scheduler="dpm++", inpaint_mask=True, init_latents=True, generator=True), "inpaint_mask requires scheduler"),
    (dict(inpaint_mask=True, generator=True), "inpaint_mask requires init_latents"),
    (dict(inpaint_mask=True, init_latents=True), "inpaint_mask requires init_latents"),
    (dict(window_frames=16, window_stride=20), "leaves uncovered frames"),
    (dict(guidance_interval=(0.6, 0.5)), "guidance_interval must satisfy"),
    (dict(guidance_interval=(0.1, 1.5)), "guidance_interval must satisfy"),
    (dict(guidance_interval=(0.1, 0.5), scheduler="lcm", generator=True), "meaningless with the lcm"),
    (dict(guidance_interval=(0.1, 0.5), window_frames=16), "not supported with windowed"),
])
def test_denoise_refuses_bad_combinations_as_jax_does(jax_modules, kw, match):
    mods = port_modules(jax_modules)
    cond, uncond = _embeds(jax_modules)
    shape = jax_pg.latent_shape(jax_modules, 1, SECONDS)
    jkw, pkw = dict(kw), dict(kw)
    for key, jv, pv in (("generator", jax.random.PRNGKey(0), torch.Generator().manual_seed(0)),
                        ("inpaint_mask", jnp.ones((1, shape[1], 1, 1)), torch.ones(1, 1, shape[1], 1)),
                        ("init_latents", jnp.zeros(shape), torch.zeros(shape).permute(0, 3, 1, 2))):
        if key in kw:
            jkw.pop(key)
            jkw["rng" if key == "generator" else key] = jv
            pkw[key] = pv
    with pytest.raises(ValueError):
        jax_pg.denoise(jax_modules, jnp.zeros(shape), cond, uncond, 3, 2.5, **jkw)
    with pytest.raises(ValueError, match=match):
        port_gen.denoise(mods, torch.zeros(shape).permute(0, 3, 1, 2), torch.from_numpy(np.asarray(cond)),
                         torch.from_numpy(np.asarray(uncond)), 3, 2.5, **pkw)


def test_interval_steps_run_the_unet_at_batch_b_outside_the_interval(jax_modules, monkeypatch):
    """Inside ``[lo * 999, hi * 999]`` the CFG pair (2B rows), outside the
    conditional-only call (B rows), decided on the host timestep."""
    mods = port_modules(jax_modules)
    cond = torch.from_numpy(np.asarray(_embeds(jax_modules)[0]))
    seen = []
    forward = mods.unet.forward
    monkeypatch.setattr(mods.unet, "forward", lambda x, t, *a, **k: seen.append((int(t[0]), x.shape[0])) or forward(x, t, *a, **k))
    port_gen.denoise(mods, port_gen.init_noise(mods, 0, 1, SECONDS), cond, cond * 0.5, 5, 2.5, guidance_interval=(0.2, 0.7))
    assert seen == [(801, 1), (601, 2), (401, 2), (201, 2), (1, 1)]
    seen.clear()
    port_gen.denoise(mods, port_gen.init_noise(mods, 0, 1, SECONDS), cond, cond * 0.5, 2, 2.5, guidance_interval=(0.0, 1.0))
    assert [rows for _, rows in seen] == [2, 2]  # (0, 1) is the standard path
    seen.clear()
    port_gen.denoise(mods, port_gen.init_noise(mods, 0, 1, SECONDS), cond, cond * 0.5, 2, 2.5, scheduler="lcm",
                     generator=port_gen.loop_generator(0))
    assert seen == [(999, 1), (499, 1)]  # lcm: no CFG, batch B


def test_windows_ride_one_unet_call_with_uncond_halves_first(jax_modules, monkeypatch):
    mods = port_modules(jax_modules)
    cond = torch.from_numpy(np.asarray(_embeds(jax_modules, 2)[0]))
    seen = []
    forward = mods.unet.forward
    monkeypatch.setattr(mods.unet, "forward", lambda x, t, emb, **k: seen.append((tuple(x.shape), emb.clone())) or forward(x, t, emb, **k))
    lat = port_gen.init_noise(mods, 0, 2, SECONDS)  # [2, 4, 80, 4]
    port_gen.denoise(mods, lat, cond, cond * 0.0, 1, 2.5, window_frames=40, window_stride=30)
    starts = port_gen.window_starts(lat.shape[2], 40, 30)
    (shape, emb), = seen
    assert shape == (2 * len(starts) * 2, 4, 40, lat.shape[3]) and starts == (0, 30, 40)
    assert not emb[: len(starts) * 2].any() and torch.equal(emb[len(starts) * 2 :], cond.repeat(len(starts), 1))
    seen.clear()  # a window that covers the clip is the standard path
    port_gen.denoise(mods, lat, cond, cond * 0.0, 1, 2.5, window_frames=lat.shape[2])
    assert seen[0][0] == (4,) + tuple(lat.shape[1:])


# ---------------------------------------------------------------- generate


def test_dpm_generation_matches_jax_through_the_pallas_one_pass_kernel(jax_modules, monkeypatch):
    """One whole tiny DPM-Solver++ generation with the one-pass flag on in
    both packages: the JAX level-0 attention (320 tokens, ``min_tokens``
    lowered) runs the Pallas one-pass kernel in interpret mode, the port's
    runs ``flash_one_plain``. Waveform within 2e-3."""
    jfa = importlib.import_module("audioldm_tpu.kernels.flash_attention")
    traced = []
    kernel = jfa._flash_kernel_one
    for name, value in (("_ENABLED", True), ("_FORCE_INTERPRET", True), ("_MIN_TOKENS", 256), ("_flash_jits", {}), ("_ONE_PASS", True),
                        ("_flash_kernel_one", lambda *a, **k: traced.append(1) or kernel(*a, **k))):
        monkeypatch.setattr(jfa, name, value)
    monkeypatch.setattr(port_fa, "_MIN_TOKENS", 256)
    monkeypatch.setattr(port_fa, "_ONE_PASS", True)
    ids, mask, u_ids, u_mask = (jnp.asarray(a) for a in _prompts())
    rng = jax.random.PRNGKey(4)
    ref = np.asarray(jax_generate(jax_modules, ids, mask, u_ids, u_mask, rng, num_inference_steps=3,
                                  audio_length_in_s=SECONDS, guidance_scale=2.5, scheduler="dpm++"))
    assert traced  # the JAX side went through the one-pass kernel
    lat, _ = jax_pg.init_noise(jax_modules, rng, 1, SECONDS)
    calls = []
    one_plain = port_fa.flash_one_plain
    monkeypatch.setattr(port_fa, "flash_one_plain", lambda q, k, v: calls.append(tuple(q.shape)) or one_plain(q, k, v))
    out = port_gen.generate(port_modules(jax_modules), *_prompts(), num_inference_steps=3, audio_length_in_s=SECONDS,
                            guidance_scale=2.5, dtype=torch.float32, latents=_nchw(lat), device="cpu", scheduler="dpm++").numpy()
    assert calls == [(2, 2, 320, 4)] * 18
    np.testing.assert_allclose(out, ref, atol=2e-3)


def test_generate_repeats_prompts_and_seeds_the_loop(jax_modules):
    """``num_waveforms_per_prompt`` repeats each prompt row in place (the JAX
    ``jnp.repeat``), and the in-loop noise of eta > 0 depends on the seed only."""
    mods = port_modules(jax_modules)
    ids, mask, u_ids, u_mask = _prompts(2)
    ids[1, 1] = 99
    with torch.no_grad():
        cond, uncond = port_gen.encode_stage(mods, ids, mask, u_ids, u_mask, num_waveforms_per_prompt=2)
    jc, _ = jax_pg.encode_stage(jax_modules, *(jnp.asarray(a) for a in (ids, mask, u_ids, u_mask)), num_waveforms_per_prompt=2)
    np.testing.assert_allclose(cond.numpy(), np.asarray(jc), atol=1e-5)
    assert cond.shape == uncond.shape == (4, 8) and torch.equal(cond[0], cond[1]) and not torch.equal(cond[1], cond[2])
    kw = dict(num_inference_steps=2, audio_length_in_s=SECONDS, dtype=torch.float32, device="cpu", eta=1.0)
    a = port_gen.generate(mods, *_prompts(), seed=3, num_waveforms_per_prompt=2, **kw)
    assert a.shape == (2, 640) and not torch.equal(a[0], a[1])
    assert torch.equal(a, port_gen.generate(mods, *_prompts(), seed=3, num_waveforms_per_prompt=2, **kw))
    assert not torch.equal(a, port_gen.generate(mods, *_prompts(), seed=4, num_waveforms_per_prompt=2, **kw))


# ---------------------------------------------------------------- CLI


def _frames(path):
    with wave.open(str(path)) as w:
        return w.getframerate(), w.getnframes()


@pytest.mark.parametrize("flags", [
    ["--scheduler", "dpm++"],
    ["--scheduler", "lcm"],
    ["--window-seconds", "0.02"],
    ["--window-seconds", "0.02", "--window-overlap", "0.25", "--scheduler", "dpm++"],
    ["--guidance-interval", "0.05,0.65"],
    ["--guidance-interval", "0.2,0.8", "--scheduler", "dpm++"],
])
def test_cli_serves_the_sampler_flags(checkpoint, tmp_path, capsys, flags):
    out = tmp_path / "g.wav"
    cli.main(["generate", "--checkpoint", checkpoint, "--prompt", "hip hop music", "--steps", "2", "--seconds", str(SECONDS),
              "--fp32", "--device", "cpu", "--output", str(out)] + flags)
    assert f"wrote {out}" in capsys.readouterr().out
    assert _frames(out) == (16000, 640)


@pytest.mark.parametrize("flags,match", [
    (["--scheduler", "euler"], None),  # argparse refuses the choice
    (["--guidance-interval", "0.5"], "expects LO,HI"),
    (["--guidance-interval", "a,b"], "expects LO,HI"),
    (["--guidance-interval", "0.7,0.2"], "0 <= LO <= HI <= 1"),
    (["--guidance-interval", "0.1,0.6", "--scheduler", "lcm"], "meaningless with lcm"),
    (["--guidance-interval", "0.1,0.6", "--window-seconds", "5"], "not combinable"),
    (["--strength", "0.5"], "--strength requires --init-audio"),
    (["--inpaint", "0-1", "--sample-posterior"], "--inpaint/--sample-posterior require --init-audio"),
    (["--inpaint-freq", "0-4"], "--inpaint-freq requires --init-audio"),
])
def test_cli_refuses_bad_sampler_flags_before_loading(flags, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(["generate", "--checkpoint", "unused", "--prompt", "x", "--device", "cpu"] + flags)
