"""Text -> audio generation (port of audioldm_tpu/pipeline/generate.py).

    tokenize (host) -> CLAP text encode of the prompt and the "" uncond,
    L2-normalised -> per-row Gaussian init latents -> DDIM loop, each step one
    UNet call on the CFG-folded batch of 2B (uncond rows first) -> VAE decode
    -> HiFi-GAN vocoder -> 16 kHz waveform.

PyTorch runs eagerly, so the JAX package's single jitted program becomes a
chain of plain calls. The UNet and VAE run in the pipeline dtype (bf16 by
default); the text encoder, the scheduler math and the vocoder run fp32.
Latents are NCHW ``[B, C, T/4, F/4]`` (the JAX package keeps NHWC).

Every entry point takes ``device`` (default ``"cuda"``) and raises when no
GPU is present unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from audioldm_tpu_torch import resolve_device
from audioldm_tpu_torch.config import ClapTextConfig, DDIMConfig, UNetConfig, VAEConfig, VocoderConfig
from audioldm_tpu_torch.models.clap_text import ClapTextModelWithProjection
from audioldm_tpu_torch.models.scheduler import ddim_step, inference_timesteps, make_schedule
from audioldm_tpu_torch.models.unet import UNet2DConditionModel
from audioldm_tpu_torch.models.vae import AutoencoderKL
from audioldm_tpu_torch.models.vocoder import SpeechT5HifiGan


@dataclasses.dataclass
class AudioLDMModules:
    """The four models and the DDIM config (the pipeline's 'self')."""

    unet: UNet2DConditionModel
    vae: AutoencoderKL
    text_encoder: ClapTextModelWithProjection
    vocoder: SpeechT5HifiGan
    ddim_cfg: DDIMConfig = DDIMConfig()

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    def to(self, device, dtype: Optional[torch.dtype] = None) -> "AudioLDMModules":
        """Move every model to ``device`` in place; with ``dtype`` also cast
        the UNet's and VAE's linear and conv weights (norm parameters stay
        fp32, as the JAX package keeps them; the text encoder and vocoder
        stay fp32 throughout)."""
        for m in (self.text_encoder, self.vocoder, self.unet, self.vae):
            m.to(device)
        if dtype is not None:
            for m in (self.unet, self.vae):
                for sub in m.modules():
                    if isinstance(sub, (nn.Linear, nn.Conv2d)):
                        sub.to(dtype)
        return self

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, device="cuda") -> "AudioLDMModules":
        """Load an HF-layout checkpoint directory (strict state-dict load)."""
        from audioldm_tpu_torch.ckpt import load_audioldm_checkpoint

        dev = resolve_device(device)
        bundle = load_audioldm_checkpoint(checkpoint_dir)
        cfg, sds = bundle["configs"], bundle["state_dicts"]
        with torch.device(dev):
            mods = cls(
                unet=UNet2DConditionModel(cfg["unet"]),
                vae=AutoencoderKL(cfg["vae"]),
                text_encoder=ClapTextModelWithProjection(cfg["text_encoder"]),
                vocoder=SpeechT5HifiGan(cfg["vocoder"]),
                ddim_cfg=cfg["scheduler"],
            )
        for name in ("unet", "vae", "text_encoder", "vocoder"):
            getattr(mods, name).load_state_dict(sds[name], strict=True)
        return mods.eval()

    def eval(self) -> "AudioLDMModules":
        for m in (self.unet, self.vae, self.text_encoder, self.vocoder):
            m.eval()
        return self


def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter from ``generator``, as the JAX package's
    initialisers do: weights and biases uniform in ±1/sqrt(fan_in), norms 1
    and 0, embeddings N(0, 0.02)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)):
                w = m.weight
                fan_in = w.shape[0] * w[0, 0].numel() if isinstance(m, nn.ConvTranspose1d) else w[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                w.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 0.02, generator=generator)
    return module


def random_modules(
    seed: int = 0,
    unet_cfg: UNetConfig = UNetConfig(),
    vae_cfg: VAEConfig = VAEConfig(),
    text_cfg: ClapTextConfig = ClapTextConfig(),
    vocoder_cfg: VocoderConfig = VocoderConfig(),
    ddim_cfg: DDIMConfig = DDIMConfig(),
    device="cuda",
) -> AudioLDMModules:
    """Random-weight bundle made from ``seed`` (benches and smoke runs
    without checkpoint files)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        mods = AudioLDMModules(
            unet=init_random_(UNet2DConditionModel(unet_cfg), gen),
            vae=init_random_(AutoencoderKL(vae_cfg), gen),
            text_encoder=init_random_(ClapTextModelWithProjection(text_cfg), gen),
            vocoder=init_random_(SpeechT5HifiGan(vocoder_cfg), gen),
            ddim_cfg=ddim_cfg,
        )
    return mods.eval()


def encode_prompt(modules: AudioLDMModules, input_ids, attention_mask) -> torch.Tensor:
    """Pooled projected text embedding, L2-normalised: what the UNet's
    class-embedding path consumes."""
    dev = modules.device
    ids = torch.as_tensor(np.asarray(input_ids), device=dev).long()
    mask = torch.as_tensor(np.asarray(attention_mask), device=dev).long()
    emb = modules.text_encoder(ids, mask)["text_embeds"].float()
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)


def encode_stage(
    modules: AudioLDMModules, input_ids, attention_mask, uncond_ids, uncond_mask
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cond, uncond) embeddings, a single uncond row broadcast to the batch."""
    cond = encode_prompt(modules, input_ids, attention_mask)
    uncond = encode_prompt(modules, uncond_ids, uncond_mask)
    if uncond.shape[0] != cond.shape[0]:
        uncond = uncond[:1].expand(cond.shape[0], -1)
    return cond, uncond


def latent_shape(modules: AudioLDMModules, batch: int, audio_length_in_s: float) -> tuple[int, int, int, int]:
    """NCHW latent geometry for a clip length: mel frames = seconds * sr /
    hop, rounded up to a multiple of the VAE downsampling factor."""
    voc = modules.vocoder.cfg
    vae = modules.vae.cfg
    hop = int(np.prod(voc.upsample_rates))
    factor = 2 ** (len(vae.block_out_channels) - 1)
    n_frames = int(audio_length_in_s * voc.sampling_rate / hop)
    n_frames = int(math.ceil(n_frames / factor) * factor)
    return (batch, vae.latent_channels, n_frames // factor, voc.model_in_dim // factor)


def row_generator(seed: int, row: int) -> torch.Generator:
    """The CPU generator of one latent row: it depends only on ``(seed,
    row)``, so a row draws the same latents at any batch size."""
    state = np.random.SeedSequence([seed, row]).generate_state(2, dtype=np.uint32)
    return torch.Generator(device="cpu").manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)


def init_noise(
    modules: AudioLDMModules, seed: int, batch: int, audio_length_in_s: float,
    latents: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """fp32 init latents on the modules' device. Row ``i`` is drawn on the
    CPU from ``row_generator(seed, i)``, so it is the same on every device
    and at every batch size. Explicit ``latents`` (NCHW) are used as given."""
    shape = latent_shape(modules, batch, audio_length_in_s)
    if latents is None:
        latents = torch.stack([torch.randn(shape[1:], generator=row_generator(seed, i)) for i in range(batch)])
    elif tuple(latents.shape) != shape:
        raise ValueError(f"latents shape {tuple(latents.shape)} != {shape}")
    return latents.to(device=modules.device, dtype=torch.float32)


@torch.inference_mode()
def denoise(
    modules: AudioLDMModules,
    latents: torch.Tensor,
    cond_embeds: torch.Tensor,
    uncond_embeds: Optional[torch.Tensor],
    num_inference_steps: int,
    guidance_scale: float,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Deterministic (eta=0) DDIM loop with classifier-free guidance: each
    step runs the UNet once on ``cat([uncond, cond])`` rows and combines
    ``eps_u + g * (eps_c - eps_u)``. Scheduler math is fp32."""
    cfg = modules.ddim_cfg
    schedule = make_schedule(cfg, latents.device)
    ts = inference_timesteps(cfg, num_inference_steps)
    prev_ts = ts - cfg.num_train_timesteps // num_inference_steps
    do_cfg = uncond_embeds is not None and guidance_scale != 1.0
    embeds = torch.cat([uncond_embeds, cond_embeds]) if do_cfg else cond_embeds
    embeds = embeds.to(dtype)
    b = latents.shape[0]
    lat = latents.float()
    for t, t_prev in zip(ts.tolist(), prev_ts.tolist()):
        model_in = torch.cat([lat, lat]) if do_cfg else lat
        t_b = torch.full((model_in.shape[0],), t, dtype=torch.int64, device=lat.device)
        eps = modules.unet(model_in.to(dtype), t_b, embeds).float()
        if do_cfg:
            eps_u, eps_c = eps[:b], eps[b:]
            eps = eps_u + guidance_scale * (eps_c - eps_u)
        lat = ddim_step(schedule, eps, t, t_prev, lat)
    return lat


@torch.inference_mode()
def decode_latents(modules: AudioLDMModules, latents: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Scaled VAE decode: latents -> mel ``[B, 1, T, F]`` in ``dtype``."""
    return modules.vae.decode((latents / modules.vae.cfg.scaling_factor).to(dtype))


@torch.inference_mode()
def vocode(modules: AudioLDMModules, mel: torch.Tensor, original_samples: int) -> torch.Tensor:
    """Mel ``[B, 1, T, F]`` -> fp32 waveform ``[B, original_samples]``."""
    return modules.vocoder(mel[:, 0])[:, :original_samples]


def generate(
    modules: AudioLDMModules,
    input_ids,
    attention_mask,
    uncond_ids,
    uncond_mask,
    seed: int = 0,
    num_inference_steps: int = 50,
    audio_length_in_s: float = 10.0,
    guidance_scale: float = 2.5,
    dtype: torch.dtype = torch.bfloat16,
    latents: Optional[torch.Tensor] = None,
    device="cuda",
) -> torch.Tensor:
    """Full text -> audio path; returns the fp32 waveform ``[B, samples]``.

    Moves ``modules`` to ``device`` and casts its UNet and VAE to ``dtype``
    in place. ``latents`` (NCHW, optional) replaces the seeded init noise."""
    dev = resolve_device(device)
    modules.to(dev, dtype)
    with torch.inference_mode():
        cond, uncond = encode_stage(modules, input_ids, attention_mask, uncond_ids, uncond_mask)
        lat = init_noise(modules, seed, cond.shape[0], audio_length_in_s, latents)
        lat = denoise(modules, lat, cond, uncond, num_inference_steps, guidance_scale, dtype)
        mel = decode_latents(modules, lat, dtype)
        return vocode(modules, mel, int(audio_length_in_s * modules.vocoder.cfg.sampling_rate))
