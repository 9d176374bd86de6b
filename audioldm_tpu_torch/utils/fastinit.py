"""Fast random weights for benchmarks and perf tools (port of
audioldm_tpu/utils/fastinit.py): one normal draw for a whole model, cut
into its parameters, instead of one initialiser a parameter. The weight
distribution does not matter there, only shapes and dtypes. Not for
correctness paths: ``pipeline.generate.init_random_`` draws
checkpoint-faithful scales."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

__all__ = ["random_params_like", "shapes_of"]

# normalisation statistics keep their identity values, as the JAX package's do:
# the vocoder divides its input by ``scale``, which N(0, 0.02) would blow up
_IDENTITY_STATS = {"mean": 0.0, "scale": 1.0, "var": 1.0, "running_mean": 0.0, "running_var": 1.0}


def shapes_of(module: nn.Module) -> dict:
    """``{name: (shape, dtype)}`` of every floating tensor of ``module``'s
    state dict (parameters and buffers)."""
    return {k: (tuple(v.shape), v.dtype) for k, v in module.state_dict().items() if v.is_floating_point()}


@torch.no_grad()
def random_params_like(module: nn.Module, generator: Optional[torch.Generator] = None, dtype: Optional[torch.dtype] = None,
                       scale: float = 0.02) -> nn.Module:
    """Fill every floating tensor of ``module``'s state dict, in place, from
    ONE N(0, scale) draw (bf16, as the JAX package draws it) cut in state-dict
    order, on ``generator``'s device; statistics named ``mean``, ``scale``,
    ``var`` (and BatchNorm's ``running_*``) get their identity values.
    ``dtype`` also casts the module. Returns ``module``."""
    if dtype is not None:
        module.to(dtype)
    sd = {k: v for k, v in module.state_dict().items() if v.is_floating_point()}
    gdev = generator.device if generator is not None else torch.device("cpu")
    total = sum(v.numel() for k, v in sd.items() if k.rsplit(".", 1)[-1] not in _IDENTITY_STATS)
    draw = (torch.randn(total, generator=generator, device=gdev, dtype=torch.float32) * scale).to(torch.bfloat16)
    off = 0
    for k, v in sd.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf in _IDENTITY_STATS:
            v.fill_(_IDENTITY_STATS[leaf])
            continue
        v.copy_(draw[off : off + v.numel()].reshape(v.shape).to(device=v.device, dtype=v.dtype))
        off += v.numel()
    return module
