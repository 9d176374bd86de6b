"""Text -> audio generation (port of audioldm_tpu/pipeline/generate.py).

    tokenize (host) -> CLAP text encode of the prompt and the "" uncond,
    L2-normalised -> per-row Gaussian init latents -> sampler loop, each step
    one UNet call on the CFG-folded batch of 2B (uncond rows first) -> VAE
    decode -> HiFi-GAN vocoder -> 16 kHz waveform.

The samplers are DDIM (eta = 0 by default), DPM-Solver++ 2M and LCM, with
limited-interval guidance, MultiDiffusion windows for long clips, and the
entry at a later step and the inpainting projection that audio-to-audio
(``pipeline/audio2audio.py``) builds on. The loop is a Python loop over host
timesteps; its random draws come from a ``torch.Generator`` or are given.

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
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from audioldm_tpu_torch import resolve_device
from audioldm_tpu_torch.config import ClapTextConfig, DDIMConfig, UNetConfig, VAEConfig, VocoderConfig
from audioldm_tpu_torch.models.clap_text import ClapTextModelWithProjection
from audioldm_tpu_torch.models.dpm_solver import dpm_solver_step
from audioldm_tpu_torch.models.lcm import consistency_output, lcm_inference_timesteps
from audioldm_tpu_torch.models.scheduler import add_noise, ddim_step, inference_timesteps, make_schedule
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
    ids, mask = (x.to(dev) if torch.is_tensor(x) else torch.as_tensor(np.asarray(x), device=dev)
                 for x in (input_ids, attention_mask))
    ids, mask = ids.long(), mask.long()
    emb = modules.text_encoder(ids, mask)["text_embeds"].float()
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)


def encode_stage(
    modules: AudioLDMModules, input_ids, attention_mask, uncond_ids, uncond_mask, num_waveforms_per_prompt: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cond, uncond) embeddings, each prompt row repeated
    ``num_waveforms_per_prompt`` times, a single uncond row broadcast to the
    batch."""
    cond = encode_prompt(modules, input_ids, attention_mask)
    uncond = encode_prompt(modules, uncond_ids, uncond_mask)
    if num_waveforms_per_prompt > 1:
        cond = cond.repeat_interleave(num_waveforms_per_prompt, dim=0)
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


def _cpu_generator(sequence: np.random.SeedSequence) -> torch.Generator:
    state = sequence.generate_state(2, dtype=np.uint32)
    return torch.Generator(device="cpu").manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)


def row_generator(seed: int, row: int) -> torch.Generator:
    """The CPU generator of one latent row: it depends only on ``(seed,
    row)``, so a row draws the same latents at any batch size."""
    return _cpu_generator(np.random.SeedSequence([seed, row]))


def loop_generator(seed: int) -> torch.Generator:
    """The CPU generator of a request's in-loop draws (eta noise, LCM
    re-noise, inpainting projection, SDEdit noise, posterior sample): a
    stream of its own, apart from every row's init latents."""
    return _cpu_generator(np.random.SeedSequence([seed], spawn_key=(1,)))


def key_generator(key: tuple, row: Optional[int] = None) -> torch.Generator:
    """The CPU generator under a batch key ``key = (seed, *folds)``: the
    in-loop stream with ``row=None``, else row ``row``'s init latents. An
    unfolded key ``(seed,)`` gives ``loop_generator(seed)`` and
    ``row_generator(seed, row)``, what ``generate(seed=seed)`` draws. A
    folded key's streams are a family of their own (a spawn key that starts
    with the fold path), so no folded key's row ever draws the latents of
    ``row_generator(s, r)`` for any seed ``s``: a serving request seeded
    ``s`` and an unseeded row never share latents."""
    seed, *folds = (int(k) for k in key)
    if row is None:
        return _cpu_generator(np.random.SeedSequence([seed], spawn_key=(1, *folds)))
    if not folds:
        return row_generator(seed, row)
    return _cpu_generator(np.random.SeedSequence([seed], spawn_key=(2, *folds, row)))


def window_params(
    modules: AudioLDMModules, window_seconds: Optional[float], window_overlap: float
) -> tuple[Optional[int], Optional[int]]:
    """MultiDiffusion window geometry ``(frames, stride)`` in latent frames
    (validated), or ``(None, None)`` when windowing is off."""
    if window_seconds is None:
        return None, None
    if window_seconds <= 0:
        raise ValueError(f"window_seconds must be > 0, got {window_seconds}")
    if not 0.0 <= window_overlap <= 0.9:
        # below 0 the stride exceeds the window (uncovered frames, a division
        # by zero); near 1 the stride degenerates to 1 (a UNet batch of ~T windows)
        raise ValueError(f"window_overlap must be in [0, 0.9], got {window_overlap}")
    voc = modules.vocoder.cfg
    hop = int(np.prod(voc.upsample_rates))
    factor = 2 ** (len(modules.vae.cfg.block_out_channels) - 1)
    window_frames = max(1, int(round(window_seconds * voc.sampling_rate / hop / factor)))
    window_stride = max(1, int(round(window_frames * (1.0 - window_overlap))))
    return window_frames, window_stride


def window_starts(total: int, window: int, stride: int) -> tuple[int, ...]:
    """Window start offsets covering ``[0, total)``: a stride grid plus a
    last window flush with the end, so the tail is always covered."""
    if window >= total:
        return (0,)
    starts = list(range(0, total - window, stride))
    starts.append(total - window)
    return tuple(dict.fromkeys(starts))


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


def _draw(draws: Optional[dict], key: str, idx: int, shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Step ``idx``'s standard-normal draw ``key``: ``draws[key][idx]`` when
    given, else from ``generator`` (on its device, then moved)."""
    if draws is not None and key in draws:
        return torch.as_tensor(draws[key][idx]).to(device=device, dtype=torch.float32)
    if generator is None:
        raise ValueError(f"draws holds no {key!r} and no generator was given")
    return torch.randn(tuple(shape), generator=generator, device=generator.device, dtype=torch.float32).to(device)


@torch.inference_mode()
def denoise(
    modules: AudioLDMModules,
    latents: torch.Tensor,
    cond_embeds: torch.Tensor,
    uncond_embeds: Optional[torch.Tensor],
    num_inference_steps: int,
    guidance_scale: float,
    dtype: torch.dtype = torch.float32,
    eta: float = 0.0,
    generator: Optional[torch.Generator] = None,
    scheduler: str = "ddim",
    window_frames: Optional[int] = None,
    window_stride: Optional[int] = None,
    start_index: int = 0,
    inpaint_mask: Optional[torch.Tensor] = None,
    init_latents: Optional[torch.Tensor] = None,
    guidance_interval: Optional[Sequence[float]] = None,
    draws: Optional[dict] = None,
    lora=None,
    lora_scale: float = 1.0,
) -> torch.Tensor:
    """The sampler loop with classifier-free guidance: each step runs the
    UNet once on ``cat([uncond, cond])`` rows and combines ``eps_u + g *
    (eps_c - eps_u)``. Scheduler math is fp32; latents are NCHW.

    ``scheduler``: ``"ddim"`` (``eta > 0`` adds the stochastic variance
    term), ``"dpm++"`` (DPM-Solver++ 2M) or ``"lcm"`` (consistency sampling
    for an LCM-distilled adapter: no CFG, one UNet call at batch B a step,
    fresh noise between steps).

    ``window_frames`` (long clips): MultiDiffusion. Each step predicts eps on
    overlapping windows of the latent time axis, all windows in one UNet
    call, and averages the predictions where windows overlap; the scheduler
    steps the full latent. ``window_stride`` defaults to half a window. With
    ``window_frames >= T`` it is the standard path.

    ``start_index`` (audio-to-audio): enter the trajectory at
    ``ts[start_index]``; ``latents`` are already noised to that timestep.
    Not with ``"lcm"``.

    ``inpaint_mask`` (1 = regenerate, 0 = keep; broadcastable to
    ``latents``): after every DDIM update the kept region is overwritten with
    ``init_latents`` forward-noised to the step's output timestep, and with
    the clean ``init_latents`` after the last step (RePaint projection). DDIM
    only.

    ``guidance_interval`` ``(lo, hi)``: apply guidance only on steps with
    ``lo * (N - 1) <= t <= hi * (N - 1)``, N the number of train timesteps;
    the other steps run the conditional-only UNet at batch B. ``(0, 1)`` is
    the standard path. Not with ``"lcm"`` or windows.

    The in-loop draws are standard normal in the latents' shape: the eta
    noise or LCM re-noise of step ``idx`` is ``draws["step_noise"][idx]``
    and the inpainting projection's is ``draws["inpaint_noise"][idx]`` when
    ``draws`` holds them, else they come from ``generator`` in that order.

    ``lora`` and ``lora_scale`` reach every UNet call: adapters applied
    unmerged (``models/nn.py Attention``). Per-row entries (3-D, gathered
    from ``serve.engine.AdapterBank`` over the CFG-folded batch, uncond rows
    first) are not supported with windows, whose batch is not the request
    batch; the conditional-only steps of limited-interval guidance take the
    first B rows of every per-row entry (the bank tiles the same adapters
    into both halves)."""
    cfg = modules.ddim_cfg
    if scheduler not in ("ddim", "dpm++", "lcm"):
        raise ValueError(f"unknown scheduler: {scheduler}")
    has_rng = generator is not None or draws is not None
    if scheduler == "lcm":
        if not has_rng:
            raise ValueError("lcm sampling requires a generator (inter-step noise)")
        ts = lcm_inference_timesteps(cfg, num_inference_steps).tolist()
    else:
        ts = inference_timesteps(cfg, num_inference_steps)
        prev_ts = (ts - cfg.num_train_timesteps // num_inference_steps).tolist()
        ts = ts.tolist()
    if eta > 0.0 and not has_rng:
        raise ValueError("eta > 0 requires a generator")
    if start_index:
        if scheduler == "lcm":
            raise ValueError("start_index (audio-to-audio) is not supported with the lcm scheduler")
        if not 0 <= start_index < len(ts):
            raise ValueError(f"start_index {start_index} outside [0, {len(ts)})")
    if inpaint_mask is not None:
        if scheduler != "ddim":
            raise ValueError("inpaint_mask requires scheduler='ddim'")
        if init_latents is None or not has_rng:
            raise ValueError("inpaint_mask requires init_latents and a generator")
        inpaint_mask = torch.as_tensor(inpaint_mask).to(device=latents.device, dtype=torch.float32)
        init_f32 = init_latents.to(device=latents.device, dtype=torch.float32)

    schedule = make_schedule(cfg, latents.device)
    do_cfg = uncond_embeds is not None and guidance_scale != 1.0 and scheduler != "lcm"
    cond_embeds = cond_embeds.to(dtype)
    embeds = torch.cat([uncond_embeds.to(dtype), cond_embeds]) if do_cfg else cond_embeds
    b, dev = latents.shape[0], latents.device

    def unet_eps(model_in, emb, t, adapters=lora):
        t_b = torch.full((model_in.shape[0],), t, dtype=torch.int64, device=dev)
        return modules.unet(model_in.to(dtype), t_b, emb, lora=adapters, lora_scale=lora_scale).float()

    def combine(eps, rows):
        return eps[:rows] + guidance_scale * (eps[rows:] - eps[:rows]) if do_cfg else eps

    windowed = window_frames is not None and window_frames < latents.shape[2]
    per_row = _per_row(lora)
    if windowed and per_row:
        raise ValueError(
            "windowed denoise does not support per-request batched adapters (their leading dim is the "
            "unwindowed batch); merge the adapter or serve uniform batches"
        )
    lora_cond = {p: _first_rows(e, b) for p, e in lora.items()} if per_row else lora
    if windowed:
        total, win = latents.shape[2], int(window_frames)
        stride = int(window_stride) if window_stride is not None else max(1, win // 2)
        if stride > win:  # the gaps would never be denoised, and their average divides by zero
            raise ValueError(f"window_stride {stride} > window_frames {win} leaves uncovered frames")
        starts = window_starts(total, win, stride)
        counts = torch.zeros(total, dtype=torch.float32, device=dev)
        for st in starts:
            counts[st : st + win] += 1.0
        inv = (1.0 / counts)[None, None, :, None]
        # all K windows ride one UNet call, uncond halves first as in the standard path
        emb_w = cond_embeds.repeat(len(starts), 1)
        if do_cfg:
            emb_w = torch.cat([uncond_embeds.to(dtype).repeat(len(starts), 1), emb_w])

    t_lo = t_hi = None  # guidance on every step
    if guidance_interval is not None:
        lo, hi = guidance_interval
        if not 0.0 <= lo <= hi <= 1.0:
            raise ValueError(f"guidance_interval must satisfy 0 <= lo <= hi <= 1, got {guidance_interval}")
        if scheduler == "lcm":
            raise ValueError("guidance_interval is meaningless with the lcm scheduler (no CFG)")
        if windowed:
            raise ValueError("guidance_interval is not supported with windowed denoise")
        if do_cfg and not (lo == 0.0 and hi == 1.0):
            # compared in fp32, as the JAX package compares them
            t_lo, t_hi = (np.float32(x * (cfg.num_train_timesteps - 1)) for x in (lo, hi))

    def predict_eps(lat, t):
        if t_lo is not None and not t_lo <= np.float32(t) <= t_hi:
            return unet_eps(lat, cond_embeds, t, lora_cond)  # outside the interval: conditional only, at batch B
        if not windowed:
            return combine(unet_eps(torch.cat([lat, lat]) if do_cfg else lat, embeds, t), b)
        wins = torch.cat([lat[:, :, st : st + win] for st in starts])
        eps = combine(unet_eps(torch.cat([wins, wins]) if do_cfg else wins, emb_w, t), len(starts) * b)
        full = torch.zeros_like(lat)
        for i, st in enumerate(starts):
            full[:, :, st : st + win] += eps[i * b : (i + 1) * b]
        return full * inv  # the average where windows overlap

    lat = latents.float()
    if scheduler == "lcm":
        denoised = lat
        for idx, t in enumerate(ts):
            denoised = consistency_output(schedule, predict_eps(lat, t), t, lat)
            if idx + 1 < len(ts):  # re-noise to the next grid point
                noise = _draw(draws, "step_noise", idx, lat.shape, generator, dev)
                lat = add_noise(schedule, denoised, noise, ts[idx + 1])
        return denoised

    if scheduler == "dpm++":
        prev_x0, prev_lambda = torch.zeros_like(lat), torch.zeros((), device=dev)
        for idx in range(start_index, len(ts)):
            eps = predict_eps(lat, ts[idx])
            lat, prev_x0, prev_lambda = dpm_solver_step(
                schedule, eps, ts[idx], prev_ts[idx], lat, prev_x0, prev_lambda, is_first=idx == start_index
            )
        return lat

    for idx in range(start_index, len(ts)):
        t, t_prev = ts[idx], prev_ts[idx]
        eps = predict_eps(lat, t)
        noise = _draw(draws, "step_noise", idx, lat.shape, generator, dev) if eta > 0.0 else None
        lat = ddim_step(schedule, eps, t, t_prev, lat, eta=eta, noise=noise)
        if inpaint_mask is not None:
            # the kept region follows the forward process of the init latents
            # to this step's output timestep; clean once t_prev < 0
            known = init_f32
            if t_prev >= 0:
                known = add_noise(schedule, init_f32, _draw(draws, "inpaint_noise", idx, lat.shape, generator, dev), t_prev)
            lat = inpaint_mask * lat + (1.0 - inpaint_mask) * known
    return lat


def _per_row(lora) -> bool:
    """Whether ``lora`` is a bank gather: a dict with per-row (3-D) entries."""
    return isinstance(lora, dict) and any((e if isinstance(e, torch.Tensor) else e[0]).ndim == 3 for e in lora.values())


def _first_rows(entry, b: int):
    """A per-row adapter entry cut to its first ``b`` rows; 2-D entries as they are."""
    if isinstance(entry, torch.Tensor):
        return entry[:b] if entry.ndim == 3 else entry
    return tuple(x[:b] if x.ndim == 3 else x for x in entry)


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
    num_waveforms_per_prompt: int = 1,
    eta: float = 0.0,
    scheduler: str = "ddim",
    window_seconds: Optional[float] = None,
    window_overlap: float = 0.5,
    guidance_interval: Optional[Sequence[float]] = None,
    generator: Optional[torch.Generator] = None,
    lora=None,
    lora_scale: float = 1.0,
) -> torch.Tensor:
    """Full text -> audio path; returns the fp32 waveform
    ``[B * num_waveforms_per_prompt, samples]``.

    Moves ``modules`` to ``device`` and casts its UNet and VAE to ``dtype``
    in place. ``latents`` (NCHW, optional) replaces the seeded init noise.
    ``scheduler``, ``eta``, ``guidance_interval``, the MultiDiffusion
    window (``window_seconds``, ``window_overlap``) and the unmerged
    adapters (``lora``, ``lora_scale``) are those of ``denoise``.
    The in-loop noise (eta > 0, lcm) comes from ``generator``, by default
    ``loop_generator(seed)``."""
    dev = resolve_device(device)
    modules.to(dev, dtype)
    with torch.inference_mode():
        cond, uncond = encode_stage(modules, input_ids, attention_mask, uncond_ids, uncond_mask, num_waveforms_per_prompt)
        lat = init_noise(modules, seed, cond.shape[0], audio_length_in_s, latents)
        window_frames, window_stride = window_params(modules, window_seconds, window_overlap)
        lat = denoise(
            modules, lat, cond, uncond, num_inference_steps, guidance_scale, dtype, eta=eta,
            generator=generator if generator is not None else loop_generator(seed), scheduler=scheduler,
            window_frames=window_frames, window_stride=window_stride, guidance_interval=guidance_interval,
            lora=lora, lora_scale=lora_scale,
        )
        mel = decode_latents(modules, lat, dtype)
        return vocode(modules, mel, int(audio_length_in_s * modules.vocoder.cfg.sampling_rate))
