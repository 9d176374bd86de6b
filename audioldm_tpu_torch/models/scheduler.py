"""DDIM schedule tables, forward noising and the DDIM step (eta = 0, or
eta > 0 with given noise) in fp32 (port of audioldm_tpu/models/scheduler.py;
diffusers ``DDIMScheduler`` semantics)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from audioldm_tpu_torch.config import DDIMConfig


class DDIMSchedule(NamedTuple):
    alphas_cumprod: torch.Tensor  # [num_train_timesteps] fp32
    final_alpha_cumprod: torch.Tensor  # 0-d fp32
    num_train_timesteps: int
    prediction_type: str
    clip_sample: bool


def make_schedule(cfg: DDIMConfig = DDIMConfig(), device="cpu") -> DDIMSchedule:
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, cfg.num_train_timesteps, dtype=np.float64) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, cfg.num_train_timesteps, dtype=np.float64)
    else:
        raise ValueError(f"unsupported beta schedule: {cfg.beta_schedule}")
    acp = np.cumprod(1.0 - betas)
    final = 1.0 if cfg.set_alpha_to_one else acp[0]
    return DDIMSchedule(
        alphas_cumprod=torch.tensor(acp, dtype=torch.float32, device=device),
        final_alpha_cumprod=torch.tensor(final, dtype=torch.float32, device=device),
        num_train_timesteps=cfg.num_train_timesteps,
        prediction_type=cfg.prediction_type,
        clip_sample=cfg.clip_sample,
    )


def inference_timesteps(cfg: DDIMConfig, num_inference_steps: int) -> np.ndarray:
    """"leading" spacing: ``(arange(S) * (T // S)).round()[::-1] + steps_offset``."""
    if cfg.timestep_spacing != "leading":
        raise ValueError(f"unsupported timestep spacing: {cfg.timestep_spacing}")
    step_ratio = cfg.num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
    return ts + cfg.steps_offset


def add_noise(schedule: DDIMSchedule, sample: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
    """Forward diffusion ``sqrt(acp_t) x0 + sqrt(1 - acp_t) eps``; ``t`` is
    one timestep (an int) for the whole batch or an int tensor with one per
    batch row."""
    acp = schedule.alphas_cumprod[t].reshape((-1,) + (1,) * (sample.ndim - 1))
    return acp.sqrt() * sample + (1.0 - acp).sqrt() * noise


def ddim_step(
    schedule: DDIMSchedule, model_output: torch.Tensor, t: int, prev_t: int, sample: torch.Tensor,
    eta: float = 0.0, noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One DDIM update x_t -> x_prev in fp32, deterministic at ``eta = 0``;
    ``eta > 0`` adds ``sigma_t * noise`` (DDIM eq. 16) and needs ``noise``.
    ``prev_t < 0`` selects ``final_alpha_cumprod``."""
    acp_t = schedule.alphas_cumprod[t]
    acp_prev = schedule.alphas_cumprod[prev_t] if prev_t >= 0 else schedule.final_alpha_cumprod
    sqrt_acp_t, sqrt_om_t = acp_t.sqrt(), (1.0 - acp_t).sqrt()
    if schedule.prediction_type == "epsilon":
        pred_x0 = (sample - sqrt_om_t * model_output) / sqrt_acp_t
        pred_eps = model_output
    elif schedule.prediction_type == "v_prediction":
        pred_x0 = sqrt_acp_t * sample - sqrt_om_t * model_output
        pred_eps = sqrt_acp_t * model_output + sqrt_om_t * sample
    elif schedule.prediction_type == "sample":
        pred_x0 = model_output
        pred_eps = (sample - sqrt_acp_t * pred_x0) / sqrt_om_t
    else:
        raise ValueError(schedule.prediction_type)
    if schedule.clip_sample:
        pred_x0 = pred_x0.clamp(-1.0, 1.0)
        pred_eps = (sample - sqrt_acp_t * pred_x0) / sqrt_om_t
    if eta <= 0.0:
        return acp_prev.sqrt() * pred_x0 + (1.0 - acp_prev).sqrt() * pred_eps
    if noise is None:
        raise ValueError("eta > 0 requires noise")
    sigma = eta * ((1.0 - acp_prev) / (1.0 - acp_t) * (1.0 - acp_t / acp_prev)).sqrt()
    return acp_prev.sqrt() * pred_x0 + (1.0 - acp_prev - sigma**2).sqrt() * pred_eps + sigma * noise
