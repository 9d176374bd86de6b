"""LCM-LoRA consistency distillation (port of audioldm_tpu/train/distill.py):
collapse the 50-step CFG teacher into a 1-8 step student adapter.

Method (public LCM formulation: Luo et al. 2023 arXiv:2310.04378, LCM-LoRA
arXiv:2311.05556; target-network form of the consistency loss):

  1. draw a grid index n; x at grid[n] by forward noising;
  2. the student (base UNet + trainable LoRA) predicts eps at grid[n] ->
     consistency output f_theta through the c_skip/c_out boundary scalings;
  3. the frozen teacher (base UNet, no adapter) takes one CFG-guided DDIM
     step grid[n] -> grid[n - 1];
  4. the target network (the EMA of the student adapter) predicts the
     consistency output at the stepped-back point;
  5. huber (or l2) loss between student and target outputs. At t = 0 the
     boundary scalings make f the identity, anchoring the trajectory at x_0.

The distilled adapter is a regular ``LoRAAdapters``: it exports through the
PEFT bridge and serves through ``generate(..., scheduler="lcm")`` once merged
(``cli generate --scheduler lcm --lora OUT/model.safetensors``).

PyTorch runs eagerly, so the JAX package's one jitted step becomes plain
calls. The teacher's two calls and the target call need no gradient: they
run under ``no_grad``, so their level-0 attention takes the inference kernel
K1; the student keeps its graph and goes through K3 forward, K4 and K5
backward (``kernels/flash_attention.py``). JAX computes the teacher and the
target inside ``value_and_grad`` with a zero gradient, which gives the same
values. The single-device path only: no mesh.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from audioldm_tpu_torch.config import LoRAConfig, TrainConfig
from audioldm_tpu_torch.lora.adapter import LoRAAdapters
from audioldm_tpu_torch.models.lcm import consistency_output, ddim_training_grid
from audioldm_tpu_torch.models.scheduler import add_noise, make_schedule
from audioldm_tpu_torch.pipeline.generate import AudioLDMModules, encode_prompt
from audioldm_tpu_torch.train.trainer import LoRAOptimizer, encode_posterior, make_optimizer


@dataclasses.dataclass
class DistillState:
    lora: LoRAAdapters  # the student adapter (trained)
    ema_lora: LoRAAdapters  # the target network's adapter: the student's EMA, requires_grad off
    optimizer: LoRAOptimizer
    step: int = 0


def init_distill_state(lora: LoRAAdapters, cfg: TrainConfig) -> DistillState:
    """The student ``lora``, a detached copy of it as the EMA target, and the
    trainer's optimizer (clip, AdamW, schedule of ``cfg``) over the student."""
    ema = copy.deepcopy(lora).requires_grad_(False)
    return DistillState(lora=lora, ema_lora=ema, optimizer=make_optimizer(cfg, lora.parameters()), step=0)


def distill_modules(modules: AudioLDMModules, dtype: torch.dtype = torch.float32) -> AudioLDMModules:
    """Freeze every model, and with a dtype other than fp32 cast every
    floating parameter and buffer of the UNet and the VAE to it, norms
    included (``audioldm_tpu.cli distill``'s rule; the text encoder and the
    vocoder stay fp32). In place; returns ``modules``."""
    if dtype != torch.float32:
        for m in (modules.unet, modules.vae):
            m.to(dtype)
    for m in (modules.unet, modules.vae, modules.text_encoder, modules.vocoder):
        m.requires_grad_(False)
    return modules


def _is_range(w) -> bool:
    return isinstance(w, (tuple, list))


def distill_loss_fn(
    lora: LoRAAdapters,
    target_lora: LoRAAdapters,
    modules: AudioLDMModules,
    batch: dict,
    lora_scale: float,
    w: Union[float, Sequence[float]] = 2.5,
    num_ddim_steps: int = 50,
    huber_c: float = 0.001,
    loss_type: str = "huber",
    dtype: torch.dtype = torch.float32,
    remat: bool = False,
    generator: Optional[torch.Generator] = None,
    draws: Optional[dict] = None,
) -> tuple[torch.Tensor, dict]:
    """One consistency-distillation loss, differentiable with respect to
    ``lora``'s parameters only. ``batch`` holds the training keys
    (``log_mel_spec`` NCHW, ``input_ids``/``attention_mask``) plus
    ``uncond_ids``/``uncond_mask`` ``[1, L]``, the tokenized negative prompt
    of the teacher's CFG (``add_uncond_tokens``).

    ``w``: the guidance baked into the student. A float distills one
    guidance scale; a ``(lo, hi)`` pair draws w ~ U[lo, hi) a row (LCM-LoRA's
    w-marginalized variant).

    The random draws (posterior eps and noise, standard normal in the
    latents' shape; the grid index, uniform in ``[0, num_ddim_steps)``; and
    with a range ``w``, the row's w) come from ``draws``
    (``{"latent_eps", "noise", "idx"[, "w"]}``) when given, else from
    ``generator`` in that order (on the generator's device, then moved).

    ``remat=True`` recomputes the student's forward in the backward pass."""
    dev = modules.device
    dist = encode_posterior(modules, batch, dtype)
    shape = tuple(dist.mean.shape)
    b = shape[0]
    if draws is not None:
        eps, noise, idx = (torch.as_tensor(draws[k]).to(dev) for k in ("latent_eps", "noise", "idx"))
        w_row = torch.as_tensor(draws["w"]).to(dev) if _is_range(w) else None
    else:
        gdev = generator.device if generator is not None else dev
        eps, noise = (torch.randn(shape, generator=generator, device=gdev).to(dev) for _ in range(2))
        idx = torch.randint(0, num_ddim_steps, (b,), generator=generator, device=gdev).to(dev)
        w_row = None
        if _is_range(w):
            w_row = (torch.rand((b,), generator=generator, device=gdev) * (w[1] - w[0]) + w[0]).to(dev)
    with torch.no_grad():
        latents = dist.sample(eps=eps).float() * modules.vae.cfg.scaling_factor
    bshape = (-1,) + (1,) * (latents.ndim - 1)

    schedule = make_schedule(modules.ddim_cfg, dev)
    grid = torch.as_tensor(ddim_training_grid(modules.ddim_cfg, num_ddim_steps), device=dev)
    topk = modules.ddim_cfg.num_train_timesteps // num_ddim_steps
    start_t = grid[idx.long()]
    prev_t = torch.clamp(start_t - topk, min=0)
    noisy = add_noise(schedule, latents, noise.float(), start_t)

    with torch.no_grad():
        cond = encode_prompt(modules, batch["input_ids"], batch["attention_mask"])
        uncond = encode_prompt(modules, batch["uncond_ids"], batch["uncond_mask"])[:1].expand_as(cond)
    w_b = w_row.float().reshape(bshape) if w_row is not None else float(w)

    def unet_eps(x, t, emb, adapter):
        return modules.unet(x.to(dtype), t, emb.to(dtype), lora=adapter, lora_scale=lora_scale).float()

    # -- student: keeps its graph (K3 forward, K4 and K5 backward) -------------
    if remat:
        eps_student = checkpoint(lambda x, t, e: unet_eps(x, t, e, lora), noisy, start_t, cond, use_reentrant=False)
    else:
        eps_student = unet_eps(noisy, start_t, cond, lora)
    model_pred = consistency_output(schedule, eps_student, start_t, noisy)

    with torch.no_grad():  # K1 for all three calls
        # -- teacher: one CFG-guided DDIM step grid[n] -> grid[n - 1] ----------
        acp_t = schedule.alphas_cumprod[start_t].reshape(bshape)
        sqrt_acp_t, sqrt_om_t = acp_t.sqrt(), (1.0 - acp_t).sqrt()
        eps_c = unet_eps(noisy, start_t, cond, None)
        eps_u = unet_eps(noisy, start_t, uncond, None)
        x0_c = (noisy - sqrt_om_t * eps_c) / sqrt_acp_t
        x0_u = (noisy - sqrt_om_t * eps_u) / sqrt_acp_t
        x0_g = x0_c + w_b * (x0_c - x0_u)
        eps_g = eps_c + w_b * (eps_c - eps_u)
        acp_prev = schedule.alphas_cumprod[prev_t].reshape(bshape)
        x_prev = acp_prev.sqrt() * x0_g + (1.0 - acp_prev).sqrt() * eps_g

        # -- target network (the EMA adapter) ----------------------------------
        eps_target = unet_eps(x_prev, prev_t, cond, target_lora)
        target = consistency_output(schedule, eps_target, prev_t, x_prev)

    if loss_type == "huber":
        loss = torch.mean(torch.sqrt((model_pred - target) ** 2 + huber_c**2) - huber_c)
    elif loss_type == "l2":
        loss = torch.mean((model_pred - target) ** 2)
    else:
        raise ValueError(f"unknown loss_type: {loss_type}")
    return loss, {"loss": loss}


def distill_step(
    state: DistillState,
    modules: AudioLDMModules,
    batch: dict,
    lora_cfg: LoRAConfig,
    dtype: torch.dtype = torch.float32,
    w: Union[float, Sequence[float]] = 2.5,
    num_ddim_steps: int = 50,
    huber_c: float = 0.001,
    loss_type: str = "huber",
    ema_decay: float = 0.95,
    remat: bool = False,
    generator: Optional[torch.Generator] = None,
    draws: Optional[dict] = None,
) -> tuple[DistillState, dict]:
    """One distillation step: the loss's backward, the optimizer's update of
    the student, then the EMA of the updated student into the target,
    ``e = d e + (1 - d) p`` in fp32. The adapters and the optimizer's
    moments are updated in place. ``metrics``: ``loss`` and ``grad_norm``
    (before clipping), tensors on the device."""
    for p in state.optimizer.params:
        p.grad = None
    loss, _ = distill_loss_fn(
        state.lora, state.ema_lora, modules, batch, lora_cfg.scale, w=w, num_ddim_steps=num_ddim_steps,
        huber_c=huber_c, loss_type=loss_type, dtype=dtype, remat=remat, generator=generator, draws=draws,
    )
    loss.backward()
    grad_norm = state.optimizer.update(state.step)
    with torch.no_grad():
        torch._foreach_lerp_(list(state.ema_lora.parameters()), list(state.lora.parameters()), 1.0 - ema_decay)
    return dataclasses.replace(state, step=state.step + 1), {"loss": loss.detach(), "grad_norm": grad_norm}


def add_uncond_tokens(batch: dict, tokenizer, negative_prompt: str = "") -> dict:
    """Attach the tokenized negative prompt that the teacher's CFG branch
    needs (``uncond_ids``/``uncond_mask``, ``[1, L]`` int32)."""
    u = tokenizer([negative_prompt])
    out = dict(batch)
    out["uncond_ids"] = np.asarray(u["input_ids"], np.int32)
    out["uncond_mask"] = np.asarray(u["attention_mask"], np.int32)
    return out
