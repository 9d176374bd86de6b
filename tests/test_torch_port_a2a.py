"""The port's audio-to-audio path (audioldm_tpu_torch: mel front end,
resampler, wav reader, init-latent encode, SDEdit entry, inpainting, the
proximity gauges) against the JAX package, at tiny widths on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the JAX
path's random draws are made with ``jax.random`` in the test and handed to the
port as tensors. Mels are ``[B, T, F, 1]`` and latents NHWC in the JAX
package, ``[B, 1, T, F]`` and NCHW in the port: transposed at the boundary
only. Per-function tolerances are 1e-4 or tighter, whole trajectories 2e-3.
"""

import importlib
import struct
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioldm_tpu.config import MelConfig as JaxMelConfig
from audioldm_tpu.data.wavio import read_wav as jax_read_wav
from audioldm_tpu.eval import proximity as jax_prox
from audioldm_tpu.ops import mel as jax_mel
from audioldm_tpu.ops.resample import resample_np as jax_resample_np
from audioldm_tpu_torch import cli
from audioldm_tpu_torch import config as tcfg
from audioldm_tpu_torch.data.wavio import read_wav, write_wav
from audioldm_tpu_torch.eval import proximity as port_prox
from audioldm_tpu_torch.ops import mel as port_mel
from audioldm_tpu_torch.ops.resample import resample_np
from audioldm_tpu_torch.pipeline import audio2audio as port_a2a
from audioldm_tpu_torch.pipeline import generate as port_gen
from test_torch_port_pipeline import SECONDS, _prompts, checkpoint, jax_modules, port_modules  # noqa: F401  (fixtures)

jax_a2a = importlib.import_module("audioldm_tpu.pipeline.audio2audio")


def _noise(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _clip(n=640, seed=0):
    t = np.arange(n) / 16000.0
    return (0.6 * np.sin(2 * np.pi * 440.0 * t) + 0.2 * _noise(n, seed)).astype(np.float32)


def _nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32).transpose(0, 3, 1, 2).copy())


# ---------------------------------------------------------------- mel front end


@pytest.mark.parametrize("kw", [{}, dict(mel_scale="htk", norm=None), dict(sampling_rate=48000, n_fft=512, n_mels=16, fmax=14000.0)])
def test_mel_filterbank_and_window_match_jax_exactly(kw):
    np.testing.assert_array_equal(port_mel.mel_filterbank(**kw), jax_mel.mel_filterbank(**kw))
    np.testing.assert_array_equal(port_mel.hann_window(kw.get("n_fft", 1024)), jax_mel.hann_window(kw.get("n_fft", 1024)))


@pytest.mark.parametrize("shape,cfg", [
    ((16000,), {}),  # the full front end: filter 1024, hop 160, 64 mels; 100 frames padded to 1024
    ((2, 3000), dict(duration=0.1875)),  # batched, cropped to the target length
    ((700,), dict(filter_length=16, hop_length=4, win_length=16, n_mel=8, target_frames=160)),  # the tiny geometry
])
def test_log_mel_spectrogram_matches_jax(shape, cfg):
    """Seeded noise through both front ends: log-mel and magnitude STFT to
    1e-4 (two FFT libraries in fp32, and a log)."""
    wav = 0.5 * _noise(shape, 1)
    ref, ref_mag = jax_mel.log_mel_spectrogram(jnp.asarray(wav), JaxMelConfig(**cfg), return_stft=True)
    out, mag = port_mel.log_mel_spectrogram(torch.from_numpy(wav), tcfg.MelConfig(**cfg), return_stft=True)
    assert out.shape == tuple(ref.shape) and mag.shape == tuple(ref_mag.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(mag.numpy(), np.asarray(ref_mag), atol=1e-4, rtol=1e-4)
    assert torch.equal(port_mel.log_mel_spectrogram(torch.from_numpy(wav), tcfg.MelConfig(**cfg)), out)


def test_stft_magnitude_centered_and_short_window_match_jax():
    y = _noise(2000, 2)
    ref = jax_mel.stft_magnitude(jnp.asarray(y), n_fft=256, hop_length=64, win_length=200, center=True)
    out = port_mel.stft_magnitude(torch.from_numpy(y), n_fft=256, hop_length=64, win_length=200, center=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_pad_spec_compression_and_wav_helpers_match_jax():
    spec = np.abs(_noise((2, 7, 5), 3))
    for target in (4, 7, 10):
        np.testing.assert_array_equal(port_mel.pad_spec(torch.from_numpy(spec), target).numpy(),
                                      np.asarray(jax_mel.pad_spec(jnp.asarray(spec), target)))
    np.testing.assert_allclose(port_mel.dynamic_range_compression(torch.from_numpy(spec * 1e-5)).numpy(),
                               np.asarray(jax_mel.dynamic_range_compression(jnp.asarray(spec * 1e-5))), atol=1e-6)
    wav = _noise(100, 4) + 0.3
    np.testing.assert_array_equal(port_mel.normalize_wav(wav), jax_mel.normalize_wav(wav))
    for n in (60, 100, 130):
        np.testing.assert_array_equal(port_mel.pad_wav(wav, n), jax_mel.pad_wav(wav, n))
    assert tcfg.MelConfig().target_length == JaxMelConfig().target_length == 1024
    assert tcfg.MelConfig(duration=10.0).num_samples == JaxMelConfig(duration=10.0).num_samples


# ---------------------------------------------------------------- host audio helpers


@pytest.mark.parametrize("orig,new", [(48000, 16000), (44100, 16000), (8000, 16000), (16000, 16000), (22050, 16000)])
def test_resample_np_matches_jax(orig, new):
    """The polyphase resampler as a numpy correlation against the JAX
    package's strided convolution: 1e-5."""
    x = _noise((2, 1500), orig)
    ref = jax_resample_np(x, orig, new)
    out = resample_np(x, orig, new)
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-5)


def _write_raw(path, fmt_code, channels, bits, payload, extensible=False):
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else fmt_code, channels, 16000, 16000 * channels * bits // 8,
                      channels * bits // 8, bits)
    if extensible:
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt_code) + b"\x00" * 14
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(payload)) + payload
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


@pytest.mark.parametrize("kind", ["pcm16", "pcm16_stereo", "pcm8", "pcm24", "pcm32", "float32", "float64", "extensible_float32"])
def test_read_wav_matches_jax_reader(tmp_path, kind):
    x = np.clip(0.5 * _noise(64, 6), -1, 1)
    path = str(tmp_path / "x.wav")
    if kind == "pcm16":
        _write_raw(path, 1, 1, 16, np.round(x * 32767).astype("<i2").tobytes())
    elif kind == "pcm16_stereo":
        _write_raw(path, 1, 2, 16, np.round(np.stack([x, -0.5 * x], 1) * 32767).astype("<i2").tobytes() + b"\x01\x00")  # a cut last frame
    elif kind == "pcm8":
        _write_raw(path, 1, 1, 8, np.round(x * 127 + 128).astype(np.uint8).tobytes())
    elif kind == "pcm24":
        v = np.round(x * (2**23 - 1)).astype(np.int32)
        _write_raw(path, 1, 1, 24, b"".join(int(i).to_bytes(3, "little", signed=True) for i in v))
    elif kind == "pcm32":
        _write_raw(path, 1, 1, 32, np.round(x * (2**31 - 1)).astype("<i4").tobytes())
    elif kind == "float32":
        _write_raw(path, 3, 1, 32, x.astype("<f4").tobytes())
    elif kind == "float64":
        _write_raw(path, 3, 1, 64, x.astype("<f8").tobytes())
    else:
        _write_raw(path, 3, 1, 32, x.astype("<f4").tobytes(), extensible=True)
    got, sr = read_wav(path)
    want, want_sr = jax_read_wav(path)
    assert sr == want_sr == 16000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_read_wav_round_trip_and_refusals(tmp_path):
    x = np.clip(0.5 * _noise(320, 7), -1, 1)
    path = str(tmp_path / "rt.wav")
    write_wav(path, x, 16000)
    got, sr = read_wav(path)
    assert sr == 16000 and got.shape == (320,)
    np.testing.assert_allclose(got, x, atol=2.0 / 32768)  # 16-bit PCM: half a step written, 32767 against 32768 read
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"RIFX" + b"\x00" * 40)
    with pytest.raises(ValueError, match="not a RIFF/WAVE"):
        read_wav(bad)
    _write_raw(bad, 7, 1, 8, b"\x00" * 16)  # mu-law
    with pytest.raises(ValueError, match="unsupported wav"):
        read_wav(bad)
    with open(bad, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4) + b"WAVE")
    with pytest.raises(ValueError, match="missing fmt/data"):
        read_wav(bad)


# ---------------------------------------------------------------- proximity


def test_proximity_gauges_match_jax():
    a, b = _clip(4000, 1), _clip(4000, 2)
    np.testing.assert_allclose(port_prox.log_mel_host(a), jax_prox.log_mel_host(a), atol=1e-6)
    for x, y in ((a, a), (a, b), (a, _noise(3000, 3)), (a, np.zeros(4000, np.float32))):
        assert port_prox.mel_correlation(x, y) == pytest.approx(jax_prox.mel_correlation(x, y), abs=1e-6)
    assert port_prox.mel_correlation(a, a) == pytest.approx(1.0, abs=1e-6)
    assert port_prox.mel_correlation(np.zeros(4000), np.zeros(4000)) == 0.0
    u, v = _noise(8, 4), _noise(8, 5)
    assert port_prox.embedding_cosine(u, v) == pytest.approx(jax_prox.embedding_cosine(u, v), abs=1e-12)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_calibrate_vocoder_gain_lands_the_probe_at_the_target(jax_modules, scale):
    """From a near-silent, a plain and a railed conv_post the probe comes
    out at 0.3 +- 5% of the atanh scale, and the returned gain is the
    product of what was applied."""
    mods = port_modules(jax_modules)
    post = mods.vocoder.conv_post
    with torch.no_grad():
        post.weight.mul_(scale)
        post.bias.mul_(scale)
    w0 = post.weight.detach().clone()
    gain = port_prox.calibrate_vocoder_gain(mods, (1, 160, 8), iters=8)
    probe = torch.randn((1, 160, 8), generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        amp = float(mods.vocoder(probe).abs().max())
    assert 0.25 <= amp <= 0.35
    torch.testing.assert_close(post.weight.detach(), w0 * gain, rtol=1e-5, atol=0)


def test_calibrate_vocoder_gain_fails_loudly_and_restores(jax_modules):
    mods = port_modules(jax_modules)
    post = mods.vocoder.conv_post
    with torch.no_grad():
        post.weight.zero_()
        post.bias.zero_()
    with pytest.raises(RuntimeError, match="unusable for gain calibration"):
        port_prox.calibrate_vocoder_gain(mods, (1, 160, 8))
    with torch.no_grad():
        post.bias.fill_(1e4)  # railed far beyond what one pass can bring down
    w0, b0 = post.weight.detach().clone(), post.bias.detach().clone()
    with pytest.raises(RuntimeError, match="did not converge"):
        port_prox.calibrate_vocoder_gain(mods, (1, 160, 8), iters=1)
    assert torch.equal(post.weight, w0) and torch.equal(post.bias, b0)


# ---------------------------------------------------------------- audio-to-audio pieces


@pytest.mark.parametrize("steps,strength", [(50, 0.75), (20, 0.75), (10, 1.0), (4, 0.3), (3, 0.5), (7, 0.99)])
def test_a2a_start_index_matches_jax(steps, strength):
    assert port_a2a.a2a_start_index(steps, strength) == jax_a2a.a2a_start_index(steps, strength)


@pytest.mark.parametrize("steps,strength,match", [(10, 0.0, "strength must be"), (10, 1.5, "strength must be"), (3, 0.2, "too low")])
def test_a2a_start_index_raises_as_jax_does(steps, strength, match):
    with pytest.raises(ValueError, match=match):
        jax_a2a.a2a_start_index(steps, strength)
    with pytest.raises(ValueError, match=match):
        port_a2a.a2a_start_index(steps, strength)


def test_mel_config_for_matches_jax(jax_modules):
    import dataclasses

    from audioldm_tpu.config import VocoderConfig

    for jcfg, pcfg, frames in ((jax_modules.vocoder_cfg, port_modules(jax_modules).vocoder.cfg, 160),
                               (VocoderConfig(), tcfg.VocoderConfig(), 1024)):
        assert dataclasses.asdict(port_a2a.mel_config_for(pcfg, frames)) == dataclasses.asdict(jax_a2a.mel_config_for(jcfg, frames))
    full = port_a2a.mel_config_for(tcfg.VocoderConfig(), 1024)  # the reference's training front end
    assert (full.filter_length, full.hop_length, full.win_length, full.n_mel, full.mel_fmax) == (1024, 160, 1024, 64, 8000.0)


@pytest.mark.parametrize("n", [640, 200, 1000])
def test_prepare_init_mel_matches_jax(jax_modules, n):
    """Exact-length, short (padded) and long (cropped) clips: 1e-4."""
    wav = _clip(n, n)
    ref = np.asarray(jax_a2a.prepare_init_mel(wav, jax_modules, SECONDS))  # [1, T, F, 1]
    out = port_a2a.prepare_init_mel(wav, port_modules(jax_modules), SECONDS)
    assert out.shape == (1, 1, 160, 8)
    np.testing.assert_allclose(out.numpy(), ref.transpose(0, 3, 1, 2), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("times,bins", [(None, None), ([(0.01, 0.03)], None), (None, [(4, 8)]), ([(0.0, 0.005), (0.03, 0.05)], [(0, 2)]),
                                        ([(0.0131, 0.0177)], [(3, 5)])])
def test_latent_mask_matches_jax_exactly(jax_modules, times, bins):
    ref = np.asarray(jax_a2a.latent_mask(jax_modules, SECONDS, regenerate_times=times, regenerate_mel_bins=bins))
    out = port_a2a.latent_mask(port_modules(jax_modules), SECONDS, regenerate_times=times, regenerate_mel_bins=bins)
    assert out.shape == (1, 1, 80, 4)
    np.testing.assert_array_equal(out.numpy(), ref.transpose(0, 3, 1, 2))


@pytest.mark.parametrize("kw,match", [(dict(regenerate_times=[(0.02, 0.02)]), "empty time range"),
                                      (dict(regenerate_mel_bins=[(5, 3)]), "empty mel-bin range")])
def test_latent_mask_raises_as_jax_does(jax_modules, kw, match):
    with pytest.raises(ValueError, match=match):
        jax_a2a.latent_mask(jax_modules, SECONDS, **kw)
    with pytest.raises(ValueError, match=match):
        port_a2a.latent_mask(port_modules(jax_modules), SECONDS, **kw)


@pytest.mark.parametrize("sample", [False, True])
def test_encode_init_latents_matches_jax(jax_modules, sample):
    """Posterior mode, and a posterior sample from the JAX draw: 1e-4."""
    mel = jax_a2a.prepare_init_mel(_clip(), jax_modules, SECONDS)
    rng = jax.random.PRNGKey(2)
    ref = np.asarray(jax_a2a.encode_init_latents(jax_modules, mel, rng=rng if sample else None))
    eps = _nchw(jax.random.normal(rng, ref.shape, jnp.float32)) if sample else None
    out = port_a2a.encode_init_latents(port_modules(jax_modules), _nchw(mel), eps=eps)
    assert out.dtype == torch.float32 and out.shape == (1, 4, 80, 4)
    np.testing.assert_allclose(out.numpy(), ref.transpose(0, 3, 1, 2), atol=1e-4)
    if sample:  # and from a generator: another draw, the same posterior
        mods = port_modules(jax_modules)
        a = port_a2a.encode_init_latents(mods, _nchw(mel), generator=torch.Generator().manual_seed(0))
        assert torch.equal(a, port_a2a.encode_init_latents(mods, _nchw(mel), generator=torch.Generator().manual_seed(0)))
        assert not torch.equal(a, port_a2a.encode_init_latents(mods, _nchw(mel)))


# ---------------------------------------------------------------- the slice against JAX

A2A_CASES = {
    "style_transfer": dict(steps=4, kw=dict(strength=0.75)),
    "style_transfer_dpm++": dict(steps=4, kw=dict(strength=0.5, scheduler="dpm++")),
    "style_transfer_sampled_posterior": dict(steps=3, kw=dict(strength=1.0, sample_posterior=True)),
    "inpaint_time": dict(steps=4, kw=dict(strength=0.75), times=[(0.01, 0.03)]),
    "inpaint_freq": dict(steps=3, kw=dict(strength=1.0), bins=[(4, 8)]),
}


@pytest.mark.parametrize("case", list(A2A_CASES))
def test_generate_mel_from_audio_matches_jax(jax_modules, case):
    """Style transfer and inpainting at tiny geometry, CFG 2.5, batch 2 from
    one init clip, fp32. The JAX function splits its key three ways
    (loop, SDEdit noise, posterior); the test makes those draws and hands
    them to the port. Output mel within 2e-3."""
    spec = A2A_CASES[case]
    steps, kw = spec["steps"], spec["kw"]
    mel = jax_a2a.prepare_init_mel(_clip(seed=3), jax_modules, SECONDS)
    prompts = _prompts(2)
    rng = jax.random.PRNGKey(11)
    mask = pmask = None
    if "times" in spec or "bins" in spec:
        mask = jax_a2a.latent_mask(jax_modules, SECONDS, spec.get("times"), spec.get("bins"))
        pmask = _nchw(mask)
    ref = np.asarray(jax_a2a.generate_mel_from_audio(jax_modules, mel, *(jnp.asarray(a) for a in prompts), rng,
                                                     num_inference_steps=steps, inpaint_mask=mask, **kw))
    loop_rng, noise_rng, enc_rng = jax.random.split(rng, 3)
    shape = (2, 80, 4, 4)  # NHWC
    draws = {"init_noise": _nchw(jax.random.normal(noise_rng, shape, jnp.float32)),
             "latent_eps": _nchw(jax.random.normal(enc_rng, (1,) + shape[1:], jnp.float32)),
             "inpaint_noise": [_nchw(jax.random.normal(jax.random.fold_in(jax.random.fold_in(loop_rng, i), 1), shape, jnp.float32))
                               for i in range(steps)]}
    out = port_a2a.generate_mel_from_audio(port_modules(jax_modules), _nchw(mel), *prompts, num_inference_steps=steps,
                                           inpaint_mask=pmask, draws=draws, **kw)
    assert out.shape == (2, 1, 160, 8)
    np.testing.assert_allclose(out.numpy(), ref.transpose(0, 3, 1, 2), atol=2e-3)


def test_generate_from_audio_end_to_end(jax_modules):
    """The whole path from a generator: waveform shape and range, the same
    seed the same clip, and inpainting keeps the kept latents at the init."""
    mods = port_modules(jax_modules)
    mel = port_a2a.prepare_init_mel(_clip(), mods, SECONDS)
    kw = dict(audio_length_in_s=SECONDS, dtype=torch.float32, device="cpu", num_inference_steps=3, strength=0.75)
    a = port_a2a.generate_from_audio(mods, mel, *_prompts(), seed=1, **kw)
    assert a.shape == (1, 640) and torch.isfinite(a).all() and a.abs().max() <= 1.0
    assert torch.equal(a, port_a2a.generate_from_audio(mods, mel, *_prompts(), seed=1, **kw))
    assert not torch.equal(a, port_a2a.generate_from_audio(mods, mel, *_prompts(), seed=2, **kw))
    mask = port_a2a.latent_mask(mods, SECONDS, regenerate_times=[(0.0, 0.02)])
    lat = port_a2a.latents_from_audio(mods, mel, *_prompts(), port_gen.loop_generator(1), num_inference_steps=3,
                                      strength=0.75, inpaint_mask=mask)
    init = port_a2a.encode_init_latents(mods, mel)
    keep = (mask == 0).expand_as(lat)
    assert torch.equal(lat[keep], init[keep]) and not torch.equal(lat[~keep], init[~keep])
    with pytest.raises(ValueError, match="inpaint_mask requires scheduler"):
        port_a2a.latents_from_audio(mods, mel, *_prompts(), port_gen.loop_generator(1), num_inference_steps=4,
                                    scheduler="dpm++", inpaint_mask=mask)
    with pytest.raises(ValueError, match="no 'init_noise' and no generator"):
        port_a2a.latents_from_audio(mods, mel, *_prompts(), num_inference_steps=3)


def test_a2a_entry_point_needs_a_gpu_unless_asked_for_cpu(jax_modules, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mods = port_modules(jax_modules)
    mel = port_a2a.prepare_init_mel(_clip(), mods, SECONDS)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        port_a2a.generate_from_audio(mods, mel, *_prompts(), audio_length_in_s=SECONDS, num_inference_steps=2)


# ---------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def source_wav(tmp_path_factory):
    """A 48 kHz stereo source clip: the CLI downmixes and resamples it."""
    path = str(tmp_path_factory.mktemp("src") / "src.wav")
    x = _clip(1920, 9)
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(48000)
        w.writeframes(np.round(np.stack([x, 0.5 * x], 1) * 32767).astype("<i2").tobytes())
    return path


@pytest.mark.parametrize("flags,says", [
    ([], "style transfer (strength 0.75)"),
    (["--strength", "0.5", "--scheduler", "dpm++"], "style transfer (strength 0.5)"),
    (["--sample-posterior"], "style transfer"),
    (["--inpaint", "0.01-0.03"], "inpainting"),
    (["--inpaint-freq", "4-8", "--strength", "1.0"], "inpainting"),
    (["--inpaint", "0-0.01,0.03-0.04", "--inpaint-freq", "0-2", "--sample-posterior"], "inpainting"),
])
def test_cli_serves_the_audio_to_audio_flags(checkpoint, source_wav, tmp_path, capsys, flags, says):
    out = tmp_path / "a2a.wav"
    cli.main(["generate", "--checkpoint", checkpoint, "--prompt", "hip hop music", "--steps", "4", "--seconds", str(SECONDS),
              "--fp32", "--device", "cpu", "--output", str(out), "--init-audio", source_wav] + flags)
    printed = capsys.readouterr().out
    assert f"audio-to-audio from {source_wav}: {says}" in printed and f"wrote {out}" in printed
    with wave.open(str(out)) as w:
        assert (w.getframerate(), w.getnframes()) == (16000, 640)


@pytest.mark.parametrize("flags,match", [
    (["--window-seconds", "5"], "not combinable with --window-seconds"),
    (["--guidance-interval", "0.1,0.6"], "not combinable"),
    (["--scheduler", "lcm"], "supports ddim/dpm\\+\\+"),
    (["--strength", "0.1", "--steps", "4"], "too low for --steps 4"),
    (["--inpaint", "0-1", "--scheduler", "dpm++"], "require --scheduler ddim"),
    (["--inpaint-freq", "0-4", "--scheduler", "dpm++"], "require --scheduler ddim"),
])
def test_cli_refuses_bad_audio_to_audio_flags_before_loading(flags, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(["generate", "--checkpoint", "unused", "--prompt", "x", "--device", "cpu", "--init-audio", "x.wav"] + flags)


@pytest.mark.parametrize("spec", ["0-1-2", "a-b", "3"])
def test_cli_refuses_malformed_inpaint_ranges(checkpoint, source_wav, spec):
    with pytest.raises(SystemExit, match="expect LO-HI"):
        cli.main(["generate", "--checkpoint", checkpoint, "--prompt", "x", "--steps", "2", "--seconds", str(SECONDS), "--fp32",
                  "--device", "cpu", "--init-audio", source_wav, "--inpaint", spec])
