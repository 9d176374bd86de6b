"""Tensor-parallel (Megatron-style) UNet: generation latency across GPUs and
the combined (dp, tp) training step (port of audioldm_tpu/parallel/tp.py).

The JAX package states the split as GSPMD shardings and lets XLA insert the
collectives. There is no GSPMD here, so the column/row split is written out
by hand, as Megatron-LM writes it:

- Attention: ``to_q``/``to_k``/``to_v`` keep this rank's output columns, so
  the rank holds ``heads / tp`` whole heads and runs the flash kernels (K1;
  K3-K5 under a gradient) on its local heads, no communication inside the
  softmax. ``to_out`` keeps the matching input columns; its partial
  products are summed by one all-reduce, and its bias is added once, after
  it.
- GEGLU feed-forward: ``net[0].proj`` keeps this rank's ``[h_d | gate_d]``
  rows of the shard-interleaved layout (``_interleave_geglu``), so that
  ``h * gelu(gate)`` is local, and ``net[2]`` keeps the matching input
  columns, then one all-reduce and its bias.
- Everything else (convolutions, norms, embeddings, the VAE, the text tower,
  the vocoder) runs whole on every rank.

Splitting rules, the port's form of the JAX "kernel vetoed per call" rule:
an attention splits only when ``heads % tp == 0``, a feed-forward only when
``tp > 1`` and its hidden width divides ``tp``; any other block runs whole
on every rank, which gives the same output. ``unet_tp_specs`` states the
JAX package's specs path for path, in torch's ``[out, in]`` layout.

Backward (``make_tp_train_step``): the forward all-reduce is an autograd
Function whose backward is the identity, and the replicated input of a
column split passes the conjugate Function (identity forward, all-reduce of
the gradient backward), so the gradients of everything upstream are whole.
The adapters stay whole on every rank: the forward slices them to the local
columns (column splits: B's; row splits: A's rows, whose delta is added
before the all-reduce), so a split projection's adapter gradients are
partial sums that one all-reduce over the tp group completes
(``reduce_tp_grads``). The port's adapters target the attention projections
only (``lora/adapter.py``), so no feed-forward entry needs slicing; densified
``[.., in, out]`` serving entries slice the same way.

``module_shardings`` (a ``NamedSharding`` tree) and ``kernels/sharding.py``
(the shard_map bridge of the Pallas kernels) have no counterpart: each CUDA
kernel runs on the local batch and the local heads of its own rank.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from audioldm_tpu_torch.config import UNetConfig
from audioldm_tpu_torch.models.nn import Attention, sdpa
from audioldm_tpu_torch.models.unet import GEGLU, BasicTransformerBlock
from audioldm_tpu_torch.parallel.mesh import Mesh, _make, all_reduce_, shard_batch, world_size


def make_tp_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A 1-D ``tp`` mesh over every process of the job."""
    return _make(("tp",), (n_devices or world_size(),), device)


def make_tp_mesh_2d(dp: int, tp: int, device="cuda") -> Mesh:
    """A ``(dp, tp)`` mesh: tp groups are runs of adjacent ranks (their
    all-reduces run every block), dp groups stride across them (one gradient
    all-reduce a step)."""
    return _make(("dp", "tp"), (dp, tp), device)


def unet_tp_specs(unet: nn.Module, tp: int = 1) -> dict:
    """``{parameter name: spec}`` for every parameter of ``unet``: the JAX
    package's ``unet_tp_specs`` in torch's layout, a tuple with ``"tp"`` on
    the split dim. Column splits (output features) are ``("tp", None)`` for
    a weight and ``("tp",)`` for a bias, row splits (input features)
    ``(None, "tp")``, everything else ``()``. Attention projections always
    split (the JAX specs do; ``shard_unet_params`` keeps a block whole when
    its heads do not divide); the GEGLU feed-forward splits when ``tp > 1``
    and its hidden width divides ``tp``."""
    specs = {}
    for name, p in unet.named_parameters():
        keys = name.split(".")
        spec = ()
        if len(keys) >= 3 and keys[-3] in ("attn1", "attn2") and keys[-2] in ("to_q", "to_k", "to_v") and keys[-1] == "weight":
            spec = ("tp", None)
        elif len(keys) >= 4 and keys[-4] in ("attn1", "attn2") and keys[-3:] == ["to_out", "0", "weight"]:
            spec = (None, "tp")
        elif ".ff.net.0.proj." in f".{name}" and tp > 1 and (p.shape[0] // 2) % tp == 0:
            spec = ("tp", None) if keys[-1] == "weight" else ("tp",)
        elif ".ff.net.2." in f".{name}" and keys[-1] == "weight" and tp > 1 and p.shape[1] % tp == 0:
            spec = (None, "tp")
        specs[name] = spec
    return specs


def _interleave_geglu(t: torch.Tensor, tp: int, dim: int = -1) -> torch.Tensor:
    """Permute the geglu outputs ``[h | gate]`` along ``dim`` into
    ``[h_0 | gate_0 | h_1 | gate_1 | ...]``, so that a ``tp``-way split of
    ``dim`` holds one matching (h, gate) pair a rank (the JAX package's
    layout; ``dim=0`` for torch's ``[out, in]`` weight)."""
    t = t.movedim(dim, -1)
    half = t.shape[-1] // 2
    lead = t.shape[:-1]
    h = t[..., :half].reshape(*lead, tp, half // tp)
    g = t[..., half:].reshape(*lead, tp, half // tp)
    return torch.cat([h, g], dim=-1).reshape(*lead, 2 * half).movedim(-1, dim)


class _CopyToTP(torch.autograd.Function):
    """Identity forward; backward sums the gradient over the tp group (the
    replicated input of a column split)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce (sum) forward over the tp group; identity backward (every
    rank's partial product receives the whole output's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _copy_in(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group) if torch.is_grad_enabled() and x.requires_grad else x


def _reduce_out(x: torch.Tensor, group) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromTP.apply(x, group)
    dist.all_reduce(x, group=group)  # a fresh matmul output: reduced in place
    return x


def _local_entry(entry, kind: str, sl: slice):
    """A LoRA entry cut to this rank's part of its projection: ``col`` keeps
    B's (or a densified AB's) local output columns, ``row`` A's (or AB's)
    local input rows. Per-row ``[rows, ...]`` entries slice the same dims."""
    if entry is None:
        return None
    if isinstance(entry, torch.Tensor):
        return entry[..., sl] if kind == "col" else entry[..., sl, :]
    a, b = entry
    return (a, b[..., sl]) if kind == "col" else (a[..., sl, :], b)


def _linear_from(weight: torch.Tensor, bias: Optional[torch.Tensor], like: nn.Linear) -> nn.Linear:
    """An ``nn.Linear`` holding copies of ``weight`` and ``bias``, frozen
    or not as ``like`` is."""
    out_f, in_f = weight.shape
    lin = nn.Linear(in_f, out_f, bias=bias is not None, device=weight.device, dtype=weight.dtype)
    with torch.no_grad():
        lin.weight.copy_(weight)
        if bias is not None:
            lin.bias.copy_(bias)
    return lin.requires_grad_(like.weight.requires_grad)


class TPAttention(Attention):
    """This rank's heads of an ``Attention``: q/k/v column-split, ``to_out``
    row-split, one all-reduce, then ``to_out``'s bias."""

    def __init__(self, attn: Attention, rank: int, tp: int, group):
        nn.Module.__init__(self)
        c = attn.to_q.out_features
        cl = c // tp
        self.cols = slice(rank * cl, (rank + 1) * cl)
        self.heads = attn.heads // tp
        self.path = attn.path
        self.group = group
        self.to_q, self.to_k, self.to_v = (_linear_from(lin.weight.detach()[self.cols], None, lin)
                                           for lin in (attn.to_q, attn.to_k, attn.to_v))
        out = attn.to_out[0]
        self.to_out = nn.ModuleList([_linear_from(out.weight.detach()[:, self.cols], out.bias.detach(), out),
                                     nn.Dropout(0.0)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None, lora=None, lora_scale: float = 1.0) -> torch.Tensor:
        x = _copy_in(x, self.group)
        context = x if context is None else _copy_in(context, self.group)
        b, n, _ = x.shape
        h, cl = self.heads, self.to_q.out_features

        def proj(name: str, linear: nn.Linear, inp: torch.Tensor, kind: str) -> torch.Tensor:
            y = F.linear(inp, linear.weight)  # to_out's bias comes after the all-reduce
            entry = _local_entry(lora.get(f"{self.path}.{name}") if lora is not None else None, kind, self.cols)
            if isinstance(entry, torch.Tensor):  # densified AB
                y = y + lora_scale * torch.matmul(inp, entry.to(inp.dtype))
            elif entry is not None:
                y = y + lora_scale * torch.matmul(torch.matmul(inp, entry[0].to(inp.dtype)), entry[1].to(inp.dtype))
            return y

        def split(t):
            return t.view(b, t.shape[1], h, cl // h).transpose(1, 2)

        out = sdpa(split(proj("to_q", self.to_q, x, "col")), split(proj("to_k", self.to_k, context, "col")),
                   split(proj("to_v", self.to_v, context, "col")))
        y = proj("to_out", self.to_out[0], out.transpose(1, 2).reshape(b, n, cl), "row")
        return _reduce_out(y, self.group) + self.to_out[0].bias


class TPFeedForward(nn.Module):
    """This rank's part of a GEGLU ``FeedForward``: its ``[h_d | gate_d]``
    rows of the interleaved ``net[0].proj``, the matching input columns of
    ``net[2]``, one all-reduce, then ``net[2]``'s bias."""

    def __init__(self, ff: nn.Module, rank: int, tp: int, group):
        super().__init__()
        proj, out = ff.net[0].proj, ff.net[2]
        inner = proj.out_features // 2
        il = inner // tp
        rows = slice(rank * 2 * il, (rank + 1) * 2 * il)
        geglu = GEGLU(proj.in_features, il)
        geglu.proj = _linear_from(_interleave_geglu(proj.weight.detach(), tp, dim=0)[rows],
                                  _interleave_geglu(proj.bias.detach(), tp)[rows], proj)
        self.net = nn.ModuleList([geglu, nn.Dropout(0.0),
                                  _linear_from(out.weight.detach()[:, rank * il:(rank + 1) * il], out.bias.detach(), out)])
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(self.net[0](_copy_in(x, self.group)), self.net[2].weight)
        return _reduce_out(y, self.group) + self.net[2].bias


def shard_unet_params(mesh: Mesh, unet: nn.Module) -> nn.Module:
    """A copy of ``unet`` holding this rank's part of every block that
    splits (``TPAttention``, ``TPFeedForward``); the rest is whole. The
    input ``unet`` is left as it is."""
    tp, rank, group = mesh.axis_size("tp"), mesh.coords.get("tp", 0), mesh.groups["tp"]
    unet = copy.deepcopy(unet)
    for blk in [m for m in unet.modules() if isinstance(m, BasicTransformerBlock)]:
        for name in ("attn1", "attn2"):
            attn = getattr(blk, name)
            if attn.heads % tp == 0:
                setattr(blk, name, TPAttention(attn, rank, tp, group))
        if tp > 1 and (blk.ff.net[0].proj.out_features // 2) % tp == 0:
            blk.ff = TPFeedForward(blk.ff, rank, tp, group)
    return unet


def split_blocks(unet: nn.Module) -> int:
    """The number of split attentions and feed-forwards in ``unet``: each
    runs one all-reduce a UNet call."""
    return sum(isinstance(m, (TPAttention, TPFeedForward)) for m in unet.modules())


def shard_modules(mesh: Mesh, modules):
    """The modules for TP: the UNet split (``shard_unet_params``), the VAE,
    text tower and vocoder whole on every rank (shared with ``modules``)."""
    return dataclasses.replace(modules, unet=shard_unet_params(mesh, modules.unet))


def make_tp_unet_step(cfg: UNetConfig, mesh: Mesh):
    """The TP epsilon step ``(unet, latents, t, class_labels) -> eps``:
    ``unet`` from ``shard_unet_params``, activations whole on every rank
    (latency mode: the heads are split, not the batch), output whole."""

    @torch.inference_mode()
    def step(unet, latents, t, class_labels):
        return unet(latents, t, class_labels)

    return step


def make_tp_generate_fn(
    modules, mesh: Mesh, num_inference_steps: int = 50, audio_length_in_s: float = 10.0,
    guidance_scale: float = 2.5, dtype: torch.dtype = torch.bfloat16, scheduler: str = "ddim",
):
    """Tensor-parallel text -> audio, the latency mode across GPUs.
    ``modules`` from ``shard_modules``. Returns ``fn(input_ids,
    attention_mask, uncond_ids, uncond_mask, seed=0, lora=None,
    lora_scale=1.0, latents=None) -> waveform``, ``pipeline.generate`` on
    this rank's device: every rank computes the whole CFG batch, the UNet's
    heads and feed-forward width are split, and an adapter (whole on every
    rank) is sliced to the local columns inside each split block.

    The JAX package turns the fused MRF vocoder kernel off under TP: its
    Pallas call has no GSPMD partitioning rule. No such rule exists here;
    the vocoder runs whole on each rank through K2."""
    from audioldm_tpu_torch.pipeline.generate import generate

    def fn(input_ids, attention_mask, uncond_ids, uncond_mask, seed: int = 0, lora=None, lora_scale: float = 1.0,
           latents=None):
        return generate(modules, input_ids, attention_mask, uncond_ids, uncond_mask, seed=seed,
                        num_inference_steps=num_inference_steps, audio_length_in_s=audio_length_in_s,
                        guidance_scale=guidance_scale, dtype=dtype, latents=latents, device=mesh.device,
                        scheduler=scheduler, lora=lora, lora_scale=lora_scale)

    return fn


def reduce_tp_grads(lora, unet: nn.Module, mesh: Mesh) -> None:
    """Complete the adapter gradients of every split attention: each rank
    holds the partial sums of its columns, one coalesced all-reduce over
    the tp group sums them. Adapters of blocks that run whole already hold
    the same whole gradient on every rank."""
    split = {m.path for m in unet.modules() if isinstance(m, TPAttention)}
    grads = [p.grad for path, a, b in lora.items() if path.rpartition(".")[0] in split for p in (a, b)]
    all_reduce_(grads, mesh, "tp", mean=False)


def make_tp_train_step(modules, lora_cfg, mesh: Mesh, dtype: torch.dtype = torch.float32, remat: bool = False):
    """The LoRA train step on a ``(dp, tp)`` mesh: the batch splits over
    dp, the UNet's blocks over tp (``modules`` from ``shard_modules``), the
    adapters and the optimizer state are whole on every rank. Returns
    ``fn(state, batch, generator=None, draws=None) -> (state, metrics)``
    with ``train.trainer.train_step``'s contract on the GLOBAL batch: the
    draws are made for the global batch (or given whole) and each rank keeps
    its rows, so the step equals the single-device step on the same batch.
    Per step: the tp all-reduces of every split block forward and backward,
    ``reduce_tp_grads``, then one dp all-reduce of the gradients."""
    from audioldm_tpu_torch.train.trainer import train_step

    def fn(state, batch, generator=None, draws=None):
        return train_step(state, modules, shard_batch(mesh, batch), lora_cfg, dtype, 1, remat, generator, draws,
                          mesh=mesh)

    return fn
