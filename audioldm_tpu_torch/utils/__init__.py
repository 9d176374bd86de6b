"""Utilities of the port: ``MetricLogger`` (JSONL, optional wandb and
tensorboard)."""

from audioldm_tpu_torch.utils.logging import MetricLogger

__all__ = ["MetricLogger"]
