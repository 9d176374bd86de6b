"""Utilities of the port: ``MetricLogger`` (JSONL, optional wandb and
tensorboard), ``trace_context``/``annotate`` (torch.profiler), the fast
random weights of ``fastinit``, the FLOP counter of ``flops`` and the
helpers of ``tools`` (dataset json, checkpoint discovery, MD5, downloads)."""

from audioldm_tpu_torch.utils.logging import MetricLogger
from audioldm_tpu_torch.utils.profiling import annotate, trace_context

__all__ = ["MetricLogger", "annotate", "trace_context"]
