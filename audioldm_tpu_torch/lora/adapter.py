"""LoRA adapters for the UNet's attention projections (port of
audioldm_tpu/lora/adapter.py).

- training wraps every targeted ``to_q``/``to_k``/``to_v``/``to_out`` linear
  as ``W x + (alpha/r) * (x A) B`` with only A and B trainable;
- inference merges trained adapters into the base UNet at load time,
  ``W += (alpha/r) A B``, for zero-overhead sampling;
- PEFT and diffusers LoRA state dicts are importable and exportable.

Where the JAX package keeps a parallel pytree, the port keeps one
``nn.Module``, ``LoRAAdapters``: fp32 ``nn.Parameter``s ``a [in, r]`` and
``b [r, out]`` (the JAX layout, so ``x @ a @ b`` is the delta) keyed by the
module path of the linear they adapt, e.g.
``down_blocks.0.attentions.1.transformer_blocks.0.attn1.to_q`` (``to_out``
for diffusers' ``to_out.0``). It is separate from the frozen UNet, so an
optimizer over ``adapters.parameters()`` sees only the adapters. Init
follows peft: ``gaussian`` is ``A ~ N(0, 1/r^2)``, ``B = 0``; anything else is
kaiming-uniform A.
"""

from __future__ import annotations

import math
import re
from typing import Iterator, Optional, Sequence

import torch
import torch.nn as nn

from audioldm_tpu_torch.config import LoRAConfig
from audioldm_tpu_torch.models.nn import Attention

# Attention projection leaves that can host adapters.
_PROJ_NAMES = ("to_q", "to_k", "to_v", "to_out")


def _key(path: str) -> str:
    return path.replace(".", "/")  # parameter names may not contain dots


class LoRAAdapters(nn.Module):
    """``{path: (a [in, r], b [r, out])}`` as fp32 parameters."""

    def __init__(self, tensors: Optional[dict] = None):
        super().__init__()
        self.a = nn.ParameterDict()
        self.b = nn.ParameterDict()
        for path, (a, b) in (tensors or {}).items():
            self.a[_key(path)] = nn.Parameter(a.detach().clone().float())
            self.b[_key(path)] = nn.Parameter(b.detach().clone().float())

    def paths(self) -> list[str]:
        return [k.replace("/", ".") for k in self.a.keys()]

    def get(self, path: str) -> Optional[tuple[torch.Tensor, torch.Tensor]]:
        """``(a, b)`` of the linear at ``path``, or None without an adapter."""
        key = _key(path)
        return (self.a[key], self.b[key]) if key in self.a else None

    def items(self) -> Iterator[tuple[str, torch.Tensor, torch.Tensor]]:
        for path in self.paths():
            yield (path, *self.get(path))


def _linear(unet: nn.Module, path: str) -> nn.Linear:
    """The ``nn.Linear`` that the adapter at ``path`` adapts."""
    mod = unet.get_submodule(path)
    return mod[0] if isinstance(mod, nn.ModuleList) else mod


def iter_lora_paths(unet: nn.Module, target_modules: Sequence[str]) -> Iterator[tuple[str, nn.Linear]]:
    """``(path, linear)`` for every attention projection of ``unet`` whose
    leaf name is in ``target_modules``: peft's match-by-leaf-name rule."""
    for name, mod in unet.named_modules():
        if isinstance(mod, Attention):
            for proj in _PROJ_NAMES:
                if proj in target_modules:
                    yield f"{name}.{proj}", _linear(mod, proj)


def init_lora(unet: nn.Module, cfg: LoRAConfig = LoRAConfig(), generator: Optional[torch.Generator] = None) -> LoRAAdapters:
    """Fresh adapters for ``unet`` on its device, A drawn from ``generator``
    (on the generator's device, so a CPU generator gives the same adapters on
    every device)."""
    dev = next(unet.parameters()).device
    draw_dev = generator.device if generator is not None else dev
    tensors = {}
    for path, lin in iter_lora_paths(unet, cfg.target_modules):
        d_out, d_in = lin.weight.shape
        if cfg.init_lora_weights == "gaussian":
            a = torch.randn((d_in, cfg.r), generator=generator, device=draw_dev) * (1.0 / cfg.r)
        else:  # kaiming-uniform over the [r, d_in] torch layout
            bound = math.sqrt(6.0 / d_in)
            a = (torch.rand((d_in, cfg.r), generator=generator, device=draw_dev) * 2.0 - 1.0) * bound
        tensors[path] = (a.to(dev), torch.zeros((cfg.r, d_out), device=dev))
    return LoRAAdapters(tensors)


@torch.no_grad()
def merge_lora(unet: nn.Module, lora: LoRAAdapters, cfg: LoRAConfig, sign: float = 1.0) -> nn.Module:
    """``W += (alpha/r) A B`` at every adapter path, in place on ``unet``
    (the delta is computed in fp32 and cast to W's dtype; ``nn.Linear`` keeps
    W as ``[out, in]``, so the delta is transposed). Returns ``unet``."""
    for path, a, b in lora.items():
        w = _linear(unet, path).weight
        delta = torch.matmul(a.float(), b.float()).T.to(device=w.device, dtype=w.dtype)
        w.add_(delta, alpha=sign * cfg.scale)
    return unet


def unmerge_lora(unet: nn.Module, lora: LoRAAdapters, cfg: LoRAConfig) -> nn.Module:
    """Undo ``merge_lora`` (exact up to W's rounding)."""
    return merge_lora(unet, lora, cfg, sign=-1.0)


def compose_adapters(parts: Sequence[tuple[LoRAAdapters, LoRAConfig, float]]) -> tuple[LoRAAdapters, LoRAConfig]:
    """Exact weighted composition of adapters into one (peft's
    ``add_weighted_adapter(combination_type="cat")``): the composed delta
    ``sum_i w_i (alpha_i/r_i) A_i B_i`` is held by concatenating along the
    rank axis with each ``B_i`` pre-scaled by ``w_i * scale_i``, under a
    composed config of scale 1. Adapters may target different modules; a
    path missing from some simply concatenates fewer ranks."""
    if not parts:
        raise ValueError("compose_adapters needs at least one (adapters, cfg, weight)")
    pieces: dict = {}
    for lora, cfg, w in parts:
        for path, a, b in lora.items():
            entry = pieces.setdefault(path, ([], []))
            entry[0].append(a.detach().float())
            entry[1].append(float(w) * cfg.scale * b.detach().float())
    composed = LoRAAdapters({p: (torch.cat(a_s, dim=1), torch.cat(b_s, dim=0)) for p, (a_s, b_s) in pieces.items()})
    r_total = sum(cfg.r for _, cfg, _ in parts)
    targets: list[str] = []
    for _, cfg, _ in parts:
        targets.extend(t for t in cfg.target_modules if t not in targets)
    return composed, LoRAConfig(r=r_total, lora_alpha=float(r_total), target_modules=tuple(targets))


# ---------------------------------------------------------------------------
# PEFT state-dict bridge
# ---------------------------------------------------------------------------


def _parse_peft_key(key: str) -> Optional[tuple[str, str]]:
    m = re.match(r"^(?:base_model\.model\.)?(.+?)\.(lora_A|lora_B)(?:\.default)?\.weight$", key)
    if m:
        return m.group(1), m.group(2)
    # diffusers-converted format: ...to_q.lora.down.weight / .lora.up.weight
    m = re.match(r"^(?:base_model\.model\.)?(.+?)\.lora\.(down|up)\.weight$", key)
    if m:
        return m.group(1), "lora_A" if m.group(2) == "down" else "lora_B"
    return None


def import_peft_state_dict(sd: dict) -> tuple[LoRAAdapters, int]:
    """A PEFT (or diffusers-converted) LoRA state dict -> ``(adapters,
    rank)``. Accepts the key layouts of ``get_peft_model_state_dict``, of
    ``accelerator.save_state`` (``.default.`` adapter names) and of
    ``convert_state_dict_to_diffusers`` (``.lora.down/up.``)."""
    found: dict = {}
    rank = 0
    for key, v in sd.items():
        parsed = _parse_peft_key(key)
        if parsed is None:
            continue
        module, ab = parsed
        v = torch.as_tensor(v).float()
        entry = found.setdefault(module.replace("to_out.0", "to_out"), {})
        if ab == "lora_A":  # torch [r, in] -> a [in, r]
            entry["a"] = v.T
            rank = v.shape[0]
        else:  # torch [out, r] -> b [r, out]
            entry["b"] = v.T
            rank = max(rank, v.shape[1])
    return LoRAAdapters({p: (e["a"], e["b"]) for p, e in found.items()}), rank


def export_peft_state_dict(lora: LoRAAdapters, prefix: str = "base_model.model.") -> dict:
    """A PEFT-format state dict (``...lora_A.weight`` [r, in],
    ``...lora_B.weight`` [out, r]; contiguous CPU tensors), loadable by
    peft and by ``import_peft_state_dict``."""
    out = {}
    for path, a, b in lora.items():
        module = re.sub(r"to_out$", "to_out.0", path)
        out[f"{prefix}{module}.lora_A.weight"] = a.detach().T.contiguous().cpu()
        out[f"{prefix}{module}.lora_B.weight"] = b.detach().T.contiguous().cpu()
    return out
