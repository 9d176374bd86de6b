"""Shared building blocks of the port's models.

Activations are NCHW / NCW (PyTorch's layout); parameters carry the
diffusers/transformers module names, so HF-layout state dicts load with
``load_state_dict(strict=True)``. Numerics follow the JAX package
(audioldm_tpu/models/nn.py): group and layer norms run in fp32 whatever the
activation dtype, GELU is the exact erf form, attention's softmax is fp32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from audioldm_tpu_torch.kernels import flash_attention as _fa


def group_norm(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """Two-pass fp32 GroupNorm over [B, C, ...] (mean, then the variance of
    the centred values), cast back to the input dtype."""
    b, c = x.shape[:2]
    g = norm.num_groups
    xf = x.float().reshape(b, g, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = (xc * torch.rsqrt(var + norm.eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    y = y * norm.weight.float().reshape(shape) + norm.bias.float().reshape(shape)
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """fp32 LayerNorm over the last dim, cast back to the input dtype."""
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(), norm.eps)
    return y.to(x.dtype)


# activations by config name; F.gelu is the exact (erf) GELU
ACT = {"silu": F.silu, "swish": F.silu, "gelu": F.gelu, "relu": F.relu, "tanh": torch.tanh}


def timestep_embedding(
    timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0, max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal embedding of diffusers ``Timesteps`` (fp32)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over ``[B, H, N, D]`` with the softmax in fp32. A call that
    ``flash_attention.routes`` accepts goes to the flash kernels (K1, or
    K3-K5 when a gradient is needed; their plain versions on the CPU); every
    other call is plain matmul attention."""
    if _fa.routes(q.device, q.shape[2], k.shape[2], q.shape[3], mask is not None):
        return _fa.flash_attention(q, k, v)
    return _fa.sdpa_plain(q, k, v, mask)


class Attention(nn.Module):
    """diffusers ``Attention`` (bias-free q/k/v, ``to_out = [Linear,
    Dropout]``). With ``context=None`` it self-attends.

    ``lora`` (a ``lora.adapter.LoRAAdapters``, or any mapping with its
    ``get``) adds the unmerged low-rank path ``y = W x + lora_scale * (x A)
    B`` to each projection it holds an adapter for, under this module's
    ``path`` (its name inside the model, set by the model that owns it). An
    entry is ``(A [in, r], B [r, out])``, the training-time LoRA; or per-row
    ``(A [rows, in, r], B [rows, r, out])`` gathered from an adapter bank,
    ``rows`` being the CFG-folded batch, which ``matmul`` broadcasts over
    ``x [rows, N, in]``; or one densified delta ``AB [rows, in, out]``, a
    tensor, applied as ``lora_scale * x AB`` (``serve.engine.AdapterBank``).
    The adapter tensors are cast to the activation dtype."""

    path = ""

    def __init__(self, query_dim: int, heads: int, context_dim: Optional[int] = None):
        super().__init__()
        context_dim = context_dim or query_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(context_dim, query_dim, bias=False)
        self.to_v = nn.Linear(context_dim, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim), nn.Dropout(0.0)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None, lora=None, lora_scale: float = 1.0) -> torch.Tensor:
        context = x if context is None else context
        b, n, c = x.shape
        h = self.heads

        def proj(name: str, linear: nn.Linear, inp: torch.Tensor) -> torch.Tensor:
            y = linear(inp)
            entry = lora.get(f"{self.path}.{name}") if lora is not None else None
            if isinstance(entry, torch.Tensor):  # densified AB
                y = y + lora_scale * torch.matmul(inp, entry.to(inp.dtype))
            elif entry is not None:
                y = y + lora_scale * torch.matmul(torch.matmul(inp, entry[0].to(inp.dtype)), entry[1].to(inp.dtype))
            return y

        def split(t):  # [b, m, c] -> [b, h, m, d] view, no copy
            return t.view(b, t.shape[1], h, c // h).transpose(1, 2)

        out = sdpa(split(proj("to_q", self.to_q, x)), split(proj("to_k", self.to_k, context)),
                   split(proj("to_v", self.to_v, context)))
        return proj("to_out", self.to_out[0], out.transpose(1, 2).reshape(b, n, c))
