"""Utilities of the port: ``MetricLogger`` (JSONL, optional wandb and
tensorboard), the span recorder ``profiling`` (``span``, ``count``, and
``trace_context`` over torch.profiler), the fast
random weights of ``fastinit``, the FLOP counter of ``flops`` and the
helpers of ``tools`` (dataset json, checkpoint discovery, MD5, downloads)."""

from audioldm_tpu_torch.utils.logging import MetricLogger
from audioldm_tpu_torch.utils.profiling import count, span, spanned, trace_context

__all__ = ["MetricLogger", "count", "span", "spanned", "trace_context"]
