"""LoRA fine-tuning trainer (port of audioldm_tpu/train/trainer.py).

- loss: ``mse(unet(add_noise(vae.encode(mel).sample() * sf, eps, t ~ U[0, 1000)),
  t, class_labels=l2norm(text_embeds)), eps)``;
- optimizer: global-norm clip 1.0, then AdamW lr 1e-5, betas (0.9, 0.999),
  weight decay 1e-5, eps 1e-8 over the adapters only, polynomial decay after
  an optional linear warm-up;
- checkpoints every ``checkpointing_steps`` with a PEFT-format adapter
  export beside them, and resume.

PyTorch runs eagerly: the JAX package's jitted ``train_step`` becomes plain
calls, its ``lax.scan`` over micro-batches a Python loop, and its immutable
state a ``TrainState`` whose adapters and optimizer moments are updated in
place. The frozen models run under ``no_grad`` where no adapter is upstream
(VAE, text tower) and with ``requires_grad=False`` weights elsewhere, so
autograd keeps gradients for A and B only. The UNet's level-0 attention is
differentiated through the flash kernels K3-K5 (kernels/flash_attention.py).
The single-device path only: no mesh.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from audioldm_tpu_torch import resolve_device
from audioldm_tpu_torch.config import LoRAConfig, TrainConfig
from audioldm_tpu_torch.lora.adapter import LoRAAdapters, export_peft_state_dict
from audioldm_tpu_torch.models.scheduler import add_noise, make_schedule
from audioldm_tpu_torch.pipeline.generate import AudioLDMModules, encode_prompt


def make_lr_schedule(cfg: TrainConfig, lr_end: float = 1e-7, power: float = 1.0) -> Callable[[int], float]:
    """The learning rate at optimizer count ``step``: linear warm-up from 0
    over ``lr_warmup_steps``, then polynomial decay from ``learning_rate`` to
    ``lr_end`` over ``max_train_steps - lr_warmup_steps`` steps, starting at
    the end of the warm-up. Used by the optimizer and by ``Trainer.fit``'s
    logging alike."""
    warmup = cfg.lr_warmup_steps
    span = max(cfg.max_train_steps - warmup, 1)

    def schedule(step: int) -> float:
        if step < warmup:
            return cfg.learning_rate * step / warmup
        frac = 1.0 - min(max(step - warmup, 0), span) / span
        return (cfg.learning_rate - lr_end) * frac**power + lr_end

    return schedule


def clip_by_global_norm_(params: list, max_norm: float) -> torch.Tensor:
    """Scale the ``.grad`` of ``params`` by ``max_norm / norm`` when their
    global L2 norm is at or above ``max_norm`` and leave them as they are
    below it (``optax.clip_by_global_norm``; torch's ``clip_grad_norm_``
    divides by ``norm + 1e-6`` instead). Returns the norm before clipping.
    No host synchronisation; the gradients become views of one flat buffer."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    norm = torch.linalg.vector_norm(flat)
    clipped = torch.where(norm < max_norm, flat, flat / norm * max_norm)
    for p, piece in zip(params, clipped.split([g.numel() for g in grads])):
        p.grad = piece.view_as(p)
    return norm


class LoRAOptimizer:
    """Global-norm clip, then AdamW at the scheduled learning rate: the
    ``optax.chain(clip_by_global_norm, adamw(schedule))`` of the JAX package.
    ``torch.optim.AdamW`` matches ``optax.adamw`` (decoupled decay times lr,
    eps outside the root, decay on A and B alike)."""

    def __init__(self, params: Iterable, cfg: TrainConfig, lr_end: float = 1e-7, power: float = 1.0):
        self.params = list(params)
        self.schedule = make_lr_schedule(cfg, lr_end, power)
        self.max_grad_norm = cfg.max_grad_norm
        self.adamw = torch.optim.AdamW(
            self.params, lr=self.schedule(0), betas=tuple(cfg.betas), eps=cfg.eps, weight_decay=cfg.weight_decay,
        )

    def update(self, count: int) -> torch.Tensor:
        """One update from the ``.grad`` of the parameters, in place, at the
        schedule's value for ``count`` (the number of updates made before
        this one). Returns the gradients' global norm before clipping."""
        norm = clip_by_global_norm_(self.params, self.max_grad_norm)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(count)
        self.adamw.step()
        return norm

    def state_dict(self) -> dict:
        return self.adamw.state_dict()

    def load_state_dict(self, sd: dict) -> None:
        self.adamw.load_state_dict(sd)


def make_optimizer(cfg: TrainConfig, params: Iterable, lr_end: float = 1e-7, power: float = 1.0) -> LoRAOptimizer:
    return LoRAOptimizer(params, cfg, lr_end, power)


@dataclasses.dataclass
class TrainState:
    lora: LoRAAdapters
    optimizer: LoRAOptimizer
    step: int = 0


def init_train_state(lora: LoRAAdapters, cfg: TrainConfig) -> TrainState:
    return TrainState(lora=lora, optimizer=make_optimizer(cfg, lora.parameters()), step=0)


@torch.no_grad()
def encode_posterior(modules: AudioLDMModules, batch: dict, dtype: torch.dtype = torch.float32):
    """The VAE posterior of ``batch["log_mel_spec"]`` (NCHW ``[B, 1, T, F]``,
    a tensor or a numpy array), encoded in ``dtype`` on the modules'
    device."""
    mel = batch["log_mel_spec"]
    mel = mel if torch.is_tensor(mel) else torch.as_tensor(np.asarray(mel))
    return modules.vae.encode(mel.to(device=modules.device, dtype=dtype))


@torch.no_grad()
def prepare_inputs(
    modules: AudioLDMModules, batch: dict, dtype: torch.dtype = torch.float32,
    generator: Optional[torch.Generator] = None, draws: Optional[dict] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The part of the loss that no adapter touches, under ``no_grad``: VAE
    encode -> posterior sample x scaling factor -> ``add_noise`` at per-row
    ``t`` -> prompt embedding. Returns ``(noisy [dtype], t, prompt [dtype],
    noise [fp32])``.

    ``batch``: ``log_mel_spec`` NCHW ``[B, 1, T, F]``, ``input_ids`` and
    ``attention_mask`` ``[B, L]`` (tensors or numpy arrays). The three random
    draws (posterior eps and noise, standard normal in the latents' shape,
    and ``t`` uniform in ``[0, num_train_timesteps)``) come from ``draws``
    (``{"latent_eps", "noise", "t"}``) when given, else from ``generator`` in
    that order (on the generator's device, then moved)."""
    dev = modules.device
    dist = encode_posterior(modules, batch, dtype)
    shape = tuple(dist.mean.shape)
    if draws is not None:
        eps, noise, t = (torch.as_tensor(draws[k]).to(dev) for k in ("latent_eps", "noise", "t"))
    else:
        gdev = generator.device if generator is not None else dev
        eps, noise = (torch.randn(shape, generator=generator, device=gdev).to(dev) for _ in range(2))
        t = torch.randint(0, modules.ddim_cfg.num_train_timesteps, shape[:1], generator=generator, device=gdev).to(dev)
    latents = dist.sample(eps=eps).float() * modules.vae.cfg.scaling_factor
    noise = noise.float()
    noisy = add_noise(make_schedule(modules.ddim_cfg, dev), latents, noise, t.long())
    prompt = encode_prompt(modules, batch["input_ids"], batch["attention_mask"])
    return noisy.to(dtype), t.long(), prompt.to(dtype), noise


def lora_loss_fn(
    lora: LoRAAdapters, modules: AudioLDMModules, batch: dict, lora_scale: float,
    dtype: torch.dtype = torch.float32, remat: bool = False,
    generator: Optional[torch.Generator] = None, draws: Optional[dict] = None,
) -> tuple[torch.Tensor, dict]:
    """The training loss: ``prepare_inputs``, then the UNet with the
    unmerged adapters, then the fp32 MSE against the noise. Differentiable
    with respect to ``lora``'s parameters.

    ``remat=True`` recomputes the UNet forward during the backward pass
    (``torch.utils.checkpoint``): more FLOPs for less memory."""
    noisy, t, prompt, noise = prepare_inputs(modules, batch, dtype, generator, draws)

    def unet_fwd(noisy_, t_, prompt_):
        return modules.unet(noisy_, t_, prompt_, lora=lora, lora_scale=lora_scale)

    eps_pred = checkpoint(unet_fwd, noisy, t, prompt, use_reentrant=False) if remat else unet_fwd(noisy, t, prompt)
    loss = torch.mean((eps_pred.float() - noise) ** 2)
    return loss, {"loss": loss}


_LOSS_KEYS = ("log_mel_spec", "input_ids", "attention_mask")
# what stays on the host: the big intermediates, the segment starts, the scalars and the texts
_HOST_ONLY = {"waveform", "stft", "waveform_48k", "random_start", "duration", "sampling_rate", "text"}


def to_device_batch(batch: dict, device) -> dict:
    """The part of a ``data.DataPipeline`` batch that a train step takes, on
    ``device``: the loss's keys and every numeric add-on array (conditioning
    signals ride along as in the reference's collate; the loss reads only
    its own keys). Tensors already there are not copied."""
    out = {}
    for k, v in batch.items():
        if k in _LOSS_KEYS or (k not in _HOST_ONLY and isinstance(v, (np.ndarray, torch.Tensor))):
            out[k] = torch.as_tensor(v).to(device, non_blocking=True)
    return out


def to_accum_layout(batch: dict, accum: int) -> dict:
    """Reshape a flat ``[B, ...]`` batch into the ``[accum, B/accum, ...]``
    layout that gradient accumulation consumes (rank-0 leaves pass through)."""

    def reshape(x):
        if np.ndim(x) == 0:
            return x
        b = x.shape[0]
        if b % accum:
            raise ValueError(f"batch size {b} not divisible by grad_accum {accum}")
        return x.reshape(accum, b // accum, *x.shape[1:])

    return {k: reshape(v) for k, v in batch.items()}


def train_step(
    state: TrainState, modules: AudioLDMModules, batch: dict, lora_cfg: LoRAConfig,
    dtype: torch.dtype = torch.float32, grad_accum: int = 1, remat: bool = False,
    generator: Optional[torch.Generator] = None, draws: Optional[dict] = None,
) -> tuple[TrainState, dict]:
    """One optimizer step; the adapters and the optimizer's moments are
    updated in place. With ``grad_accum > 1`` the leaves of ``batch`` (and of
    ``draws``) are ``[accum, micro, ...]``, and gradients and loss are
    averaged over the micro-batches. ``metrics``: ``loss`` and ``grad_norm``
    (before clipping), tensors on the device."""
    params = state.optimizer.params
    for p in params:
        p.grad = None
    if grad_accum == 1:
        loss, _ = lora_loss_fn(state.lora, modules, batch, lora_cfg.scale, dtype, remat, generator, draws)
        loss.backward()
        loss = loss.detach()
    else:
        loss = 0.0
        for i in range(grad_accum):
            micro = {k: v if np.ndim(v) == 0 else v[i] for k, v in batch.items()}
            micro_draws = None if draws is None else {k: v[i] for k, v in draws.items()}
            l, _ = lora_loss_fn(state.lora, modules, micro, lora_cfg.scale, dtype, remat, generator, micro_draws)
            l.backward()  # accumulates into .grad
            loss = loss + l.detach()
        torch._foreach_div_([p.grad for p in params], grad_accum)
        loss = loss / grad_accum
    grad_norm = state.optimizer.update(state.step)
    return dataclasses.replace(state, step=state.step + 1), {"loss": loss, "grad_norm": grad_norm}


_KEEP_CHECKPOINTS = 3


class Trainer:
    """Host-side orchestration: data iteration, stepping, checkpoint and
    resume, metric logging. ``dtype=torch.bfloat16`` casts every fp32
    parameter and buffer of the frozen UNet, VAE and CLAP text tower to bf16
    once, norms included, as the JAX trainer casts every fp32 leaf of its
    modules (audioldm_tpu/train/trainer.py:232-236); the norms still compute
    in fp32 (``models.nn``). The adapters and the optimizer state stay fp32,
    and so does the vocoder, which the step does not run. Generation keeps
    its own rule (``AudioLDMModules.to``). Runs on ``device`` (default
    ``"cuda"``; it raises without a GPU unless the caller passes ``"cpu"``)."""

    def __init__(
        self, modules: AudioLDMModules, lora_cfg: LoRAConfig, train_cfg: TrainConfig, output_dir: str,
        dtype: torch.dtype = torch.float32, logger=None, remat: bool = False, debug_nans: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        modules.to(self.device)
        if dtype != torch.float32:
            for m in (modules.unet, modules.vae, modules.text_encoder):
                m.to(dtype)  # every floating parameter and buffer
        for m in (modules.unet, modules.vae, modules.text_encoder, modules.vocoder):
            m.requires_grad_(False)  # else autograd computes and keeps a gradient for every base weight
        self.modules = modules
        self.lora_cfg = lora_cfg
        self.train_cfg = train_cfg
        self.output_dir = output_dir
        self.dtype = dtype
        self.remat = remat
        self.logger = logger
        if debug_nans:  # raise at the first backward op that produces a NaN
            torch.autograd.set_detect_anomaly(True)

    def init_state(self, lora: LoRAAdapters) -> TrainState:
        return init_train_state(lora.to(self.device), self.train_cfg)

    def step_fn(self, state: TrainState, batch: dict, generator=None, draws=None) -> tuple[TrainState, dict]:
        return train_step(
            state, self.modules, batch, self.lora_cfg, self.dtype,
            self.train_cfg.gradient_accumulation_steps, self.remat, generator, draws,
        )

    # -- checkpointing ------------------------------------------------------
    def _ckpt_dir(self) -> str:
        return os.path.join(self.output_dir, "checkpoints")

    def _saved_steps(self) -> list[int]:
        if not os.path.isdir(self._ckpt_dir()):
            return []
        found = (re.fullmatch(r"step-(\d+)\.pt", n) for n in os.listdir(self._ckpt_dir()))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, state: TrainState) -> None:
        """Adapters, optimizer state and step into
        ``checkpoints/step-N.pt`` (the newest 3 are kept), and the adapters
        in PEFT format into ``checkpoint-N/model.safetensors``."""
        from audioldm_tpu_torch.ckpt import write_safetensors

        os.makedirs(self._ckpt_dir(), exist_ok=True)
        path = os.path.join(self._ckpt_dir(), f"step-{state.step}.pt")
        torch.save({"lora": state.lora.state_dict(), "optimizer": state.optimizer.state_dict(), "step": state.step}, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self._saved_steps()[:-_KEEP_CHECKPOINTS]:
            os.remove(os.path.join(self._ckpt_dir(), f"step-{old}.pt"))
        peft_dir = os.path.join(self.output_dir, f"checkpoint-{state.step}")
        os.makedirs(peft_dir, exist_ok=True)
        write_safetensors(os.path.join(peft_dir, "model.safetensors"), export_peft_state_dict(state.lora))

    def restore(self, state: TrainState) -> TrainState:
        """Resume from the latest checkpoint if one exists (loaded into
        ``state``'s adapters and optimizer in place)."""
        steps = self._saved_steps()
        if not steps:
            return state
        saved = torch.load(os.path.join(self._ckpt_dir(), f"step-{steps[-1]}.pt"), map_location=self.device, weights_only=True)
        state.lora.load_state_dict(saved["lora"])
        state.optimizer.load_state_dict(saved["optimizer"])
        return dataclasses.replace(state, step=int(saved["step"]))

    # -- loop ---------------------------------------------------------------
    def fit(
        self, state: TrainState, data_iter, generator: Optional[torch.Generator] = None,
        max_steps: Optional[int] = None, validate_every: Optional[int] = None, validate_fn=None,
        log_every: int = 1, steps_per_epoch: Optional[int] = None, num_epochs: Optional[int] = None,
        validate_every_epochs: Optional[int] = None, profile_dir: Optional[str] = None,
        profile_steps: tuple = (2, 5),
    ) -> tuple[TrainState, dict]:
        """Step loop with checkpointing and optional periodic validation.

        ``data_iter`` yields flat ``[B, ...]`` batches (see
        ``prepare_inputs``); the loop ends at ``max_steps`` (default
        ``max_train_steps``) or when the iterator does. Pass
        ``steps_per_epoch`` (+ ``num_epochs`` / ``validate_every_epochs``) for
        epoch semantics. ``validate_fn(state, step)`` is the caller's hook.
        ``generator`` (default: seeded from ``train_cfg.seed`` on the
        trainer's device) makes the noise draws.

        The loss accumulates on the device and is fetched only every
        ``log_every`` steps, so logging does not synchronise each step.
        ``profile_dir`` captures a ``torch.profiler`` trace over steps
        ``[profile_steps[0], profile_steps[1])`` of this call into
        ``profile_dir/trace.json``."""
        if steps_per_epoch:
            if num_epochs and max_steps is None:
                max_steps = min(num_epochs * steps_per_epoch, self.train_cfg.max_train_steps)
            if validate_every_epochs and validate_every is None:
                validate_every = validate_every_epochs * steps_per_epoch
        max_steps = max_steps or self.train_cfg.max_train_steps
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.train_cfg.seed)
        metrics: dict = {}
        total_loss = torch.zeros((), dtype=torch.float32, device=self.device)
        total_steps = 0
        lr_sched = state.optimizer.schedule
        accum = self.train_cfg.gradient_accumulation_steps
        prof = None
        while state.step < max_steps:
            if profile_dir is not None:
                if prof is None and total_steps == profile_steps[0]:
                    prof = self._start_profile()
                elif prof is not None and total_steps >= profile_steps[1]:
                    self._stop_profile(prof, profile_dir)
                    prof, profile_dir = None, None
            batch = next(data_iter, None)
            if batch is None:
                break
            if accum > 1:
                batch = to_accum_layout(batch, accum)
            state, metrics = self.step_fn(state, batch, generator)
            step = state.step
            total_loss = total_loss + metrics["loss"]
            total_steps += 1
            if self.logger is not None and step % max(log_every, 1) == 0:
                # the update that produced step N ran at optimizer count N-1
                self.logger.log(
                    {
                        "train_loss": float(metrics["loss"]),
                        "total_train_loss": float(total_loss) / total_steps,
                        "lr": float(lr_sched(step - 1)),
                        "grad_norm": float(metrics["grad_norm"]),
                        "epoch": (step - 1) // steps_per_epoch if steps_per_epoch else 0,
                    },
                    step=step,
                )
            if step % self.train_cfg.checkpointing_steps == 0:
                self.save(state)
            if validate_fn is not None and validate_every and step % validate_every == 0:
                val = validate_fn(state, step)
                if self.logger is not None and isinstance(val, dict):
                    self.logger.log({k: v for k, v in val.items() if isinstance(v, float)}, step=step)
        if prof is not None:  # the loop ended inside the profiled window
            self._stop_profile(prof, profile_dir)
        return state, metrics

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof, profile_dir: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
