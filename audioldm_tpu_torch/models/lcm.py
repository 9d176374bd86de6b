"""Latent Consistency Model schedule pieces for few-step sampling (port of
audioldm_tpu/models/lcm.py; the distillation that trains an adapter for
them is ``train/distill.py``). Semantics follow the public LCM formulation (Luo et al. 2023,
arXiv:2310.04378) as the diffusers ``LCMScheduler`` standardises it:

- boundary scalings ``c_skip``/``c_out`` with sigma_data = 0.5 and a x10
  timestep scaling;
- the consistency function ``f(x_t, t) = c_skip(t) x_t + c_out(t) x0_hat``
  on the epsilon-parametrised UNet;
- a sampling grid of every k-th point of the 50-point DDIM training grid,
  with fresh noise between steps (``pipeline.generate.denoise``).
"""

from __future__ import annotations

import numpy as np
import torch

from audioldm_tpu_torch.config import DDIMConfig
from audioldm_tpu_torch.models.scheduler import DDIMSchedule

SIGMA_DATA = 0.5
TIMESTEP_SCALING = 10.0


def boundary_scalings(t, timestep_scaling: float = TIMESTEP_SCALING) -> tuple[torch.Tensor, torch.Tensor]:
    """``(c_skip, c_out)`` in fp32 for an int or int-tensor ``t``: at t = 0
    the consistency function is the identity (c_skip = 1, c_out = 0)."""
    scaled = torch.as_tensor(t).to(torch.float32) * timestep_scaling
    c_skip = SIGMA_DATA**2 / (scaled**2 + SIGMA_DATA**2)
    c_out = scaled / torch.sqrt(scaled**2 + SIGMA_DATA**2)
    return c_skip, c_out


def ddim_training_grid(cfg: DDIMConfig, num_ddim_steps: int = 50) -> np.ndarray:
    """The ascending N-point grid of the teacher's trajectory:
    ``arange(1, N+1) * (T // N) - 1``."""
    step_ratio = cfg.num_train_timesteps // num_ddim_steps
    return (np.arange(1, num_ddim_steps + 1) * step_ratio).astype(np.int64) - 1


def lcm_inference_timesteps(cfg: DDIMConfig, num_inference_steps: int, num_ddim_steps: int = 50) -> np.ndarray:
    """Descending sampling grid: every k-th point of the training grid,
    largest first (k = N // S)."""
    if num_inference_steps > num_ddim_steps:
        raise ValueError(f"lcm steps {num_inference_steps} > training grid {num_ddim_steps}")
    grid = ddim_training_grid(cfg, num_ddim_steps)
    skip = num_ddim_steps // num_inference_steps
    return grid[::-1][::skip][:num_inference_steps].copy()


def consistency_output(schedule: DDIMSchedule, eps_pred: torch.Tensor, t, sample: torch.Tensor) -> torch.Tensor:
    """``f(x_t, t) = c_skip(t) x_t + c_out(t) x0_hat``; ``t`` is one
    timestep (an int) or an int tensor with one per batch row."""
    shape = (-1,) + (1,) * (sample.ndim - 1)
    acp = schedule.alphas_cumprod[t].reshape(shape)
    c_skip, c_out = (c.to(sample.device).reshape(shape) for c in boundary_scalings(t))
    pred_x0 = (sample - (1.0 - acp).sqrt() * eps_pred) / acp.sqrt()
    return c_skip * sample + c_out * pred_x0
