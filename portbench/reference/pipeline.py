"""Plain text-to-audio generation and the LoRA training step, in float32.

Generation: the text tower on the prompt and on the empty prompt, the
initial latents of each request from its seed, the sampler loop (DDIM at
eta 0, or DPM-Solver++ 2M) with classifier-free guidance, the VAE decode and
the vocoder. Training: VAE posterior sample, forward noising, the UNet with
the unmerged adapters, the MSE against the noise, the global-norm clip and
AdamW. The formulas are those of diffusers' ``DDIMScheduler``, of Lu et
al. 2022 (arXiv:2211.01095) and of ``torch.optim.AdamW``; the random draws
are made the way the program documents them, so that both sides see the
same numbers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.models import MODELS
from portbench.reference.ops import Arith, set_arith


def build(cfg: dict, state: dict, ar: Arith, device, names=("unet", "vae", "vocoder", "text_encoder")) -> dict:
    """The reference's models ``names`` from ``cfg``, holding ``state``'s
    tensors as float32, with arithmetic ``ar``."""
    out = {}
    for name in names:
        with torch.device("meta"):
            m = MODELS[name](cfg[name])
        sd = {k: v.float() for k, v in state[name].items()}
        m.load_state_dict(sd, strict=True, assign=True)
        out[name] = set_arith(m.to(device).eval().requires_grad_(False), ar)
    return out


# ---------------------------------------------------------------- schedule
def alphas_cumprod(sched: dict, device) -> torch.Tensor:
    n = sched["num_train_timesteps"]
    if sched["beta_schedule"] != "scaled_linear":
        raise ValueError(f"unsupported beta schedule {sched['beta_schedule']!r}")
    betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5, n, dtype=np.float64) ** 2
    return torch.tensor(np.cumprod(1.0 - betas), dtype=torch.float32, device=device)


def leading_timesteps(sched: dict, steps: int) -> list:
    ratio = sched["num_train_timesteps"] // steps
    ts = (np.arange(steps) * ratio).round()[::-1].astype(np.int64) + sched["steps_offset"]
    return ts.tolist()


def row_latents(seed: int, shape) -> torch.Tensor:
    """A request's initial latents: standard normal on the CPU from the
    generator that ``SeedSequence([seed, 0])`` seeds (two 32-bit words,
    ``w0 << 31 | w1 >> 1``)."""
    w = np.random.SeedSequence([int(seed), 0]).generate_state(2, dtype=np.uint32)
    g = torch.Generator(device="cpu").manual_seed(int(w[0]) << 31 | int(w[1]) >> 1)
    return torch.randn(tuple(shape), generator=g)


@torch.no_grad()
def generate(models: dict, cfg: dict, ids, mask, uncond_ids, uncond_mask, seeds, steps: int, guidance: float,
             seconds: float, scheduler: str = "ddim", lora=None, lora_scale: float = 1.0) -> torch.Tensor:
    """``(waveforms [B, seconds * rate], latents, mels)`` of the prompts
    ``ids``/``mask`` (``[B, L]``) with the request seeds ``seeds``; the
    latents are the sampler's result over the VAE's scaling factor (the VAE
    decode's input), the mels the decode's output ``[B, T, F]`` (the
    vocoder's input). ``lora``: ``{path: (A, B)}``, applied to every row."""
    dev = ids.device
    sched, voc, vae = cfg["scheduler"], cfg["vocoder"], cfg["vae"]
    hop = int(np.prod(voc["upsample_rates"]))
    factor = 2 ** (len(vae["block_out_channels"]) - 1)
    frames = int(math.ceil(int(seconds * voc["sampling_rate"] / hop) / factor) * factor)
    shape = (vae["latent_channels"], frames // factor, voc["model_in_dim"] // factor)
    b = ids.shape[0]
    cond = models["text_encoder"](ids, mask)
    uncond = models["text_encoder"](uncond_ids, uncond_mask)[:1].expand(b, -1)
    emb = torch.cat([uncond, cond])
    lat = torch.stack([row_latents(s, shape) for s in seeds]).to(dev)
    acp = alphas_cumprod(sched, dev)
    final = acp[0]
    ts = leading_timesteps(sched, steps)
    ratio = sched["num_train_timesteps"] // steps
    coeffs = lambda t: (acp[t] if t >= 0 else final)
    prev_x0, prev_lam = None, None
    for i, t in enumerate(ts):
        tb = torch.full((2 * b,), t, dtype=torch.int64, device=dev)
        out = models["unet"](torch.cat([lat, lat]), tb, emb, lora, lora_scale)
        eps = out[:b] + guidance * (out[b:] - out[:b])
        a_t, a_p = coeffs(t), coeffs(t - ratio)
        x0 = (lat - (1.0 - a_t).sqrt() * eps) / a_t.sqrt()
        if scheduler == "ddim":
            lat = a_p.sqrt() * x0 + (1.0 - a_p).sqrt() * eps
            continue
        alpha_t, sigma_t, alpha_p, sigma_p = a_t.sqrt(), (1.0 - a_t).sqrt(), a_p.sqrt(), (1.0 - a_p).sqrt()
        lam_t = alpha_t.log() - sigma_t.clamp_min(1e-20).log()
        lam_p = alpha_p.log() - sigma_p.clamp_min(1e-20).log()
        h = lam_p - lam_t
        if i == 0:
            d = x0
        else:
            r = (lam_t - prev_lam) / (h if h != 0 else 1.0)
            inv2r = 1.0 / (2.0 * (r if r != 0 else 1.0))
            d = (1.0 + inv2r) * x0 - inv2r * prev_x0
        lat = (sigma_p / sigma_t) * lat - alpha_p * (torch.exp(-h) - 1.0) * d
        prev_x0, prev_lam = x0, lam_t
    z = lat / vae["scaling_factor"]
    mel = models["vae"].decode(z)
    return models["vocoder"](mel[:, 0])[:, : int(seconds * voc["sampling_rate"])], z, mel[:, 0]


# ---------------------------------------------------------------- training
def lr_at(train: dict, count: int, lr_end: float = 1e-7, power: float = 1.0) -> float:
    """Linear warm-up, then polynomial decay to ``lr_end`` over the rest of
    ``max_train_steps``."""
    warm, lr = train["lr_warmup_steps"], train["learning_rate"]
    if count < warm:
        return lr * count / warm
    span = max(train["max_train_steps"] - warm, 1)
    frac = 1.0 - min(max(count - warm, 0), span) / span
    return (lr - lr_end) * frac**power + lr_end


def loss_and_grads(models: dict, cfg: dict, batch: dict, draws: dict, lora: dict, lora_scale: float,
                   rows: int = 2) -> tuple[float, dict]:
    """The training loss of one batch and its gradients with respect to the
    adapters, computed ``rows`` batch rows at a time (the loss is a mean
    over rows, so the parts add). ``lora``: ``{path: (A, B)}`` leaves that
    require grad; ``draws``: the posterior's ``latent_eps``, the ``noise``
    and the timesteps ``t``."""
    acp = alphas_cumprod(cfg["scheduler"], batch["mel"].device)
    b = batch["mel"].shape[0]
    total = 0.0
    leaves = [x for pair in lora.values() for x in pair]
    grads = [torch.zeros_like(x) for x in leaves]
    for i in range(0, b, rows):
        sl = slice(i, i + rows)
        with torch.no_grad():
            mean, logvar = models["vae"].encode(batch["mel"][sl])
            lat = (mean + torch.exp(0.5 * logvar) * draws["latent_eps"][sl]) * cfg["vae"]["scaling_factor"]
            a = acp[draws["t"][sl]].reshape(-1, 1, 1, 1)
            noisy = a.sqrt() * lat + (1.0 - a).sqrt() * draws["noise"][sl]
            prompt = models["text_encoder"](batch["ids"][sl], batch["mask"][sl])
        with torch.enable_grad():
            pred = models["unet"](noisy, draws["t"][sl], prompt, lora, lora_scale)
            part = ((pred - draws["noise"][sl]) ** 2).mean() * (pred.shape[0] / b)
            for g, d in zip(grads, torch.autograd.grad(part, leaves)):
                g += d
        total += float(part.detach())
    it = iter(grads)
    return total, {p: (next(it), next(it)) for p in lora}


def adamw_step(lora: dict, grads: dict, state: dict, train: dict, count: int) -> dict:
    """Global-norm clip (scale by ``max / norm`` when the norm is at least
    ``max``), then one decoupled-weight-decay Adam update at ``lr_at(count)``,
    in place on ``lora``. Returns the clipped gradients."""
    flat = torch.cat([g.reshape(-1) for pair in grads.values() for g in pair])
    norm = torch.linalg.vector_norm(flat)
    mx = train["max_grad_norm"]
    factor = (mx / norm) if norm >= mx else torch.ones((), device=norm.device)
    lr, (b1, b2), eps, wd = lr_at(train, count), train["betas"], train["eps"], train["weight_decay"]
    step = count + 1
    clipped = {}
    with torch.no_grad():
        for p, pair in lora.items():
            clipped[p] = []
            for j, x in enumerate(pair):
                g = grads[p][j] * factor
                m, v = state.setdefault((p, j), (torch.zeros_like(x), torch.zeros_like(x)))
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                x.mul_(1 - lr * wd)
                denom = (v / (1 - b2**step)).sqrt() + eps
                x.addcdiv_(m / (1 - b1**step), denom, value=-lr)
                clipped[p].append(g)
    return clipped
