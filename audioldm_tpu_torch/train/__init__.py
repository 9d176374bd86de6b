from audioldm_tpu_torch.train.distill import (
    DistillState,
    add_uncond_tokens,
    distill_loss_fn,
    distill_modules,
    distill_step,
    init_distill_state,
)
from audioldm_tpu_torch.train.trainer import (
    TrainState,
    Trainer,
    init_train_state,
    lora_loss_fn,
    make_lr_schedule,
    make_optimizer,
    to_accum_layout,
    to_device_batch,
    train_step,
)

__all__ = [
    "DistillState",
    "TrainState",
    "Trainer",
    "add_uncond_tokens",
    "distill_loss_fn",
    "distill_modules",
    "distill_step",
    "init_distill_state",
    "init_train_state",
    "lora_loss_fn",
    "make_lr_schedule",
    "make_optimizer",
    "to_accum_layout",
    "to_device_batch",
    "train_step",
]
