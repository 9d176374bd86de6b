"""Audio-to-audio generation: SDEdit-style style transfer and latent
inpainting or band regeneration (port of audioldm_tpu/pipeline/audio2audio.py).

- **style transfer** (SDEdit, Meng et al. 2022): VAE-encode the input mel,
  forward-noise it to the timestep ``ts[start]`` that ``strength`` selects
  (the diffusers img2img convention), and run only the remaining ``steps -
  start`` denoise steps.
- **inpainting**: a latent-space mask (1 = regenerate, 0 = keep) built from
  second ranges of the clip and/or mel-bin ranges (masking the top bins is
  diffusion super-resolution). Each DDIM step projects the kept region back
  onto the forward trajectory of the init latents (``generate.denoise``).

The init mel goes through the training front end (``ops.mel``). Latents and
masks are NCHW ``[B, C, T/4, F/4]`` and mels ``[B, 1, T, F]`` (the JAX package
keeps NHWC). The random draws (SDEdit noise, posterior sample, the loop's
noise) come from a ``torch.Generator`` or are given as tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from audioldm_tpu_torch import resolve_device
from audioldm_tpu_torch.config import MelConfig, VocoderConfig
from audioldm_tpu_torch.models.scheduler import add_noise, inference_timesteps, make_schedule
from audioldm_tpu_torch.ops.mel import log_mel_spectrogram, normalize_wav, pad_wav
from audioldm_tpu_torch.pipeline.generate import (
    AudioLDMModules,
    decode_latents,
    denoise,
    encode_stage,
    latent_shape,
    loop_generator,
    vocode,
)


def a2a_start_index(num_inference_steps: int, strength: float) -> int:
    """The diffusers img2img entry convention: run the last ``int(steps *
    strength)`` steps of the schedule. ``strength = 1.0`` keeps the whole
    trajectory (the init is still noised to ``ts[0]``, not replaced by pure
    noise)."""
    if not 0.0 < strength <= 1.0:
        raise ValueError(f"strength must be in (0, 1], got {strength}")
    init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
    if init_timestep < 1:
        raise ValueError(
            f"strength {strength} too low for {num_inference_steps} steps: int(steps * strength) must be >= 1 "
            f"(it selects how many denoise steps run); raise strength or the step count"
        )
    return max(num_inference_steps - init_timestep, 0)


def mel_config_for(vocoder_cfg: VocoderConfig, n_frames: int) -> MelConfig:
    """The mel front end that matches a vocoder geometry. At the full
    configuration (hop 160, 16 kHz, 64 mels) it is the reference's training
    front end (filter 1024, window 1024, fmax 8000); for other geometries it
    derives a consistent one: filter = next power of two >= 4 * hop, window =
    filter, fmax = Nyquist capped at 8 kHz."""
    hop = int(np.prod(vocoder_cfg.upsample_rates))
    filt = max(16, 2 ** math.ceil(math.log2(4 * hop)))
    sr = vocoder_cfg.sampling_rate
    return MelConfig(
        sampling_rate=sr, filter_length=filt, hop_length=hop, win_length=filt, n_mel=vocoder_cfg.model_in_dim,
        mel_fmin=0.0, mel_fmax=min(8000.0, sr / 2), duration=n_frames * hop / sr, target_frames=n_frames,
    )


def prepare_init_mel(wav: np.ndarray, modules: AudioLDMModules, audio_length_in_s: float) -> torch.Tensor:
    """Host wav (float, any length, at the vocoder's sample rate) -> log-mel
    ``[1, 1, T, F]`` at the pipeline's latent geometry, on the modules'
    device. The wav is mean-centred, peak-normalised to 0.5 and padded or
    cropped to the clip length, as the training data path does, so the VAE
    sees its own input distribution."""
    _, _, n_frames_lat, _ = latent_shape(modules, 1, audio_length_in_s)
    n_frames = n_frames_lat * 2 ** (len(modules.vae.cfg.block_out_channels) - 1)
    cfg = mel_config_for(modules.vocoder.cfg, n_frames)
    wav = pad_wav(normalize_wav(np.asarray(wav, np.float32)), n_frames * cfg.hop_length)
    mel = log_mel_spectrogram(torch.from_numpy(wav).to(modules.device), cfg)
    if mel.shape[-2] != n_frames:
        raise ValueError(f"mel frames {mel.shape[-2]} != latent-geometry frames {n_frames}")
    return mel[None, None]


def latent_mask(
    modules: AudioLDMModules, audio_length_in_s: float,
    regenerate_times: Optional[Sequence[Tuple[float, float]]] = None,
    regenerate_mel_bins: Optional[Sequence[Tuple[int, int]]] = None,
) -> torch.Tensor:
    """An inpainting mask ``[1, 1, T_lat, F_lat]`` (1 = regenerate) on the CPU.

    ``regenerate_times``: ``(start_s, end_s)`` ranges of the clip to
    regenerate across all frequencies. ``regenerate_mel_bins``: ``(lo, hi)``
    half-open ranges of the ``model_in_dim`` mel bins to regenerate across
    the whole clip; ``(32, 64)`` redraws the top octave. The mask is the
    union of both; with neither, everything is regenerated."""
    _, _, n_t, n_f = latent_shape(modules, 1, audio_length_in_s)
    if not regenerate_times and not regenerate_mel_bins:
        return torch.ones((1, 1, n_t, n_f), dtype=torch.float32)
    voc = modules.vocoder.cfg
    hop = int(np.prod(voc.upsample_rates))
    factor = 2 ** (len(modules.vae.cfg.block_out_channels) - 1)
    frames_per_s = voc.sampling_rate / hop / factor  # latent frames per second
    bins_per_lat = voc.model_in_dim / n_f  # mel bins per latent frequency row
    mask = np.zeros((1, 1, n_t, n_f), np.float32)
    for t0, t1 in regenerate_times or ():
        if t1 <= t0:
            raise ValueError(f"empty time range ({t0}, {t1})")
        mask[:, :, max(0, int(math.floor(t0 * frames_per_s))) : min(n_t, int(math.ceil(t1 * frames_per_s)))] = 1.0
    for b0, b1 in regenerate_mel_bins or ():
        if b1 <= b0:
            raise ValueError(f"empty mel-bin range ({b0}, {b1})")
        mask[:, :, :, max(0, int(math.floor(b0 / bins_per_lat))) : min(n_f, int(math.ceil(b1 / bins_per_lat)))] = 1.0
    return torch.from_numpy(mask)


@torch.inference_mode()
def encode_init_latents(
    modules: AudioLDMModules, mel: torch.Tensor, generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.float32, eps: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mel ``[B, 1, T, F]`` -> scaled fp32 latents. The posterior's mode by
    default; with ``generator`` or ``eps`` (standard normal, the latents'
    shape) a sample of it."""
    dist = modules.vae.encode(mel.to(device=modules.device, dtype=dtype))
    z = dist.sample(generator, eps) if generator is not None or eps is not None else dist.mode
    return z.float() * modules.vae.cfg.scaling_factor


@torch.inference_mode()
def latents_from_audio(
    modules: AudioLDMModules, mel_init: torch.Tensor, input_ids, attention_mask, uncond_ids, uncond_mask,
    generator: Optional[torch.Generator] = None, num_inference_steps: int = 50, strength: float = 0.75,
    guidance_scale: float = 2.5, dtype: torch.dtype = torch.float32, scheduler: str = "ddim",
    inpaint_mask: Optional[torch.Tensor] = None, sample_posterior: bool = False, draws: Optional[dict] = None,
    lora=None, lora_scale: float = 1.0,
) -> torch.Tensor:
    """The audio-conditioned core: encode the prompts and ``mel_init`` (``[1
    or B, 1, T, F]``, see ``prepare_init_mel``), noise the init latents to the
    entry timestep, and denoise from there. Returns the fp32 latents.

    The draws are ``draws["init_noise"]`` (the SDEdit noise) and, with
    ``sample_posterior``, ``draws["latent_eps"]``, both standard normal in
    the latents' shape, and the loop's (see ``generate.denoise``); what
    ``draws`` does not hold comes from ``generator``, in the order posterior,
    SDEdit noise, loop. ``lora`` and ``lora_scale`` are ``denoise``'s
    unmerged adapters."""
    cond, uncond = encode_stage(modules, input_ids, attention_mask, uncond_ids, uncond_mask)
    b, dev = cond.shape[0], modules.device
    draws = draws or {}
    eps = draws.get("latent_eps") if sample_posterior else None
    init = encode_init_latents(
        modules, mel_init, generator if sample_posterior and eps is None else None, dtype,
        None if eps is None else torch.as_tensor(eps).to(dev),
    )
    if init.shape[0] != b:
        init = init[:1].expand(b, *init.shape[1:])

    start = a2a_start_index(num_inference_steps, strength)
    ts = inference_timesteps(modules.ddim_cfg, num_inference_steps)
    if "init_noise" in draws:
        noise = torch.as_tensor(draws["init_noise"]).to(device=dev, dtype=torch.float32)
    elif generator is None:
        raise ValueError("draws holds no 'init_noise' and no generator was given")
    else:
        noise = torch.randn(tuple(init.shape), generator=generator, device=generator.device).to(dev)
    latents = add_noise(make_schedule(modules.ddim_cfg, dev), init, noise, int(ts[start]))
    return denoise(
        modules, latents, cond, uncond, num_inference_steps, guidance_scale, dtype, generator=generator,
        scheduler=scheduler, start_index=start, inpaint_mask=inpaint_mask,
        init_latents=init if inpaint_mask is not None else None, draws=draws, lora=lora, lora_scale=lora_scale,
    )


def generate_mel_from_audio(modules: AudioLDMModules, mel_init: torch.Tensor, *args, dtype: torch.dtype = torch.float32, **kw) -> torch.Tensor:
    """``latents_from_audio`` and the VAE decode: mel ``[B, 1, T, F]`` in ``dtype``."""
    return decode_latents(modules, latents_from_audio(modules, mel_init, *args, dtype=dtype, **kw), dtype)


def generate_from_audio(
    modules: AudioLDMModules, mel_init: torch.Tensor, input_ids, attention_mask, uncond_ids, uncond_mask,
    seed: int = 0, audio_length_in_s: float = 10.0, dtype: torch.dtype = torch.bfloat16, device="cuda",
    generator: Optional[torch.Generator] = None, **kw,
) -> torch.Tensor:
    """Full audio + text -> audio path: ``generate_mel_from_audio`` and the
    vocoder; returns the fp32 waveform ``[B, samples]``. Moves ``modules`` to
    ``device`` and casts its UNet and VAE to ``dtype`` in place. The draws
    come from ``generator``, by default ``loop_generator(seed)``; ``kw`` are
    the options of ``latents_from_audio``."""
    dev = resolve_device(device)
    modules.to(dev, dtype)
    samples = int(audio_length_in_s * modules.vocoder.cfg.sampling_rate)
    mel = generate_mel_from_audio(
        modules, mel_init, input_ids, attention_mask, uncond_ids, uncond_mask,
        generator if generator is not None else loop_generator(seed), dtype=dtype, **kw,
    )
    return vocode(modules, mel, samples)
