"""DPM-Solver++ (2M), the faster second sampler (port of
audioldm_tpu/models/dpm_solver.py): a deterministic multistep solver in the
data-prediction form over the DDIM schedule's alpha-cumprod tables. The loop
in ``pipeline.generate.denoise`` carries ``(sample, prev_x0, prev_lambda)``.

Math: Lu et al. 2022, DPM-Solver++ (arXiv:2211.01095). Timesteps are host
ints; the math is fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from audioldm_tpu_torch.models.scheduler import DDIMSchedule


def _coeffs(schedule: DDIMSchedule, t: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(alpha, sigma, lambda = log alpha - log sigma)`` at timestep ``t``;
    ``t < 0`` reads ``final_alpha_cumprod``."""
    acp = schedule.alphas_cumprod[t] if t >= 0 else schedule.final_alpha_cumprod
    alpha = acp.sqrt()
    sigma = (1.0 - acp).sqrt()
    return alpha, sigma, alpha.log() - sigma.clamp_min(1e-20).log()


def dpm_solver_step(
    schedule: DDIMSchedule, model_output: torch.Tensor, t: int, prev_t: int, sample: torch.Tensor,
    prev_x0: torch.Tensor, prev_lambda: torch.Tensor, is_first: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One DPM-Solver++ 2M update: ``(new_sample, x0, lambda_t)``. The first
    step of a trajectory (``is_first``) is the first-order, DDIM-equivalent
    update; later steps use the second-order multistep correction from the
    previous step's ``x0`` and ``lambda``."""
    alpha_t, sigma_t, lam_t = _coeffs(schedule, t)
    alpha_p, sigma_p, lam_p = _coeffs(schedule, prev_t)

    if schedule.prediction_type == "epsilon":
        x0 = (sample - sigma_t * model_output) / alpha_t
    elif schedule.prediction_type == "v_prediction":
        x0 = alpha_t * sample - sigma_t * model_output
    else:
        x0 = model_output

    h = lam_p - lam_t  # this step's size toward less noise, h > 0
    if is_first:
        d = x0
    else:
        # 2M correction: D = (1 + 1/(2r)) x0 - (1/(2r)) x0_prev; a zero step
        # size or ratio is replaced by 1, as the JAX package guards them
        one = torch.ones_like(h)
        r = (lam_t - prev_lambda) / torch.where(h == 0, one, h)
        inv2r = 1.0 / (2.0 * torch.where(r == 0, one, r))
        d = (1.0 + inv2r) * x0 - inv2r * prev_x0
    new_sample = (sigma_p / sigma_t) * sample - alpha_p * (torch.exp(-h) - 1.0) * d
    return new_sample, x0, lam_t


def solver_timesteps(num_train_timesteps: int, num_inference_steps: int, steps_offset: int = 1) -> np.ndarray:
    """The DDIM path's "leading" grid, so the two samplers compare directly."""
    step_ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
    return ts + steps_offset
