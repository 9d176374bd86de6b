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
    "TrainState",
    "Trainer",
    "init_train_state",
    "lora_loss_fn",
    "make_lr_schedule",
    "make_optimizer",
    "to_accum_layout",
    "to_device_batch",
    "train_step",
]
