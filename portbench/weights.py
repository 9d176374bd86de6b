"""Seeded random weights of a configuration, made on the device.

One uniform draw in [-1, 1) for every drawn tensor of the four models,
cut in state-dict order and scaled per tensor: linear and convolution
weights and biases by 1/sqrt(fan_in) (the default initialiser's bound),
embeddings to the standard deviation 0.02 of N(0, 0.02), norm weights 1 and
biases 0, the vocoder's normalisation statistics 0 and 1. The configuration
file's ``weights_dtype`` rounds every tensor to it (``bfloat16`` for the
bf16 configuration), so that every cast the program makes of them is exact
and the reference holds the same numbers in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from portbench.reference.models import MODELS

_IDENTITY = {"mean": 0.0, "scale": 1.0}


def _plan(model: nn.Module) -> list:
    """``(name, shape, kind, bound)`` of every state-dict tensor, in order."""
    kinds = {}
    for mname, m in model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            kinds[pre + "weight"], kinds[pre + "bias"] = ("const", 1.0), ("const", 0.0)
        elif isinstance(m, nn.Embedding):
            kinds[pre + "weight"] = ("draw", 0.02 * math.sqrt(3.0))
        elif isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)):
            w = m.weight
            fan_in = w.shape[0] * w[0, 0].numel() if isinstance(m, nn.ConvTranspose1d) else w[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            kinds[pre + "weight"] = ("draw", bound)
            if m.bias is not None:
                kinds[pre + "bias"] = ("draw", bound)
    plan = []
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _IDENTITY and name not in kinds:
            plan.append((name, tuple(t.shape), "const", _IDENTITY[leaf]))
        else:
            kind, val = kinds[name]
            plan.append((name, tuple(t.shape), kind, val))
    return plan


def make_state(cfg: dict, seed: int, device, names=("unet", "vae", "vocoder", "text_encoder")) -> dict:
    """``{model: {tensor name: tensor}}`` for ``names``, drawn from ``seed``
    on ``device`` in the configuration's ``weights_dtype``."""
    dtype = getattr(torch, cfg["weights_dtype"])
    plans = {}
    for name in ("unet", "vae", "vocoder", "text_encoder"):  # a fixed order: the draw does not depend on `names`
        with torch.device("meta"):
            plans[name] = _plan(MODELS[name](cfg[name]))
    total = sum(math.prod(s) for p in plans.values() for _, s, kind, _ in p if kind == "draw")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.rand(total, generator=gen, device=device, dtype=torch.float32).mul_(2.0).sub_(1.0)
    out, off = {}, 0
    for name, plan in plans.items():
        sd = {}
        for tname, shape, kind, val in plan:
            if kind == "draw":
                n = math.prod(shape)
                t = draw[off : off + n].view(shape) * val
                off += n
            else:
                t = torch.full(shape, val, device=device, dtype=torch.float32)
            sd[tname] = t.to(dtype)
        if name in names:
            out[name] = sd
    return out
