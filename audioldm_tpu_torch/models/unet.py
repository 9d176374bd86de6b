"""UNet2DConditionModel, the epsilon-prediction denoiser (port of
audioldm_tpu/models/unet.py).

audioldm-s feeds the pooled 512-d CLAP text embedding through the
class-embedding path (``simple_projection``, concatenated onto the time
embedding) and passes no encoder hidden states, so attn2 self-attends. The
module tree carries diffusers' names (``down_blocks.0.attentions.1.
transformer_blocks.0.attn1.to_q`` ...), so a diffusers state dict loads
strictly. Traps kept from the JAX package: ``attention_head_dim`` is a head
COUNT, the transformer GroupNorm uses eps 1e-6, the GEGLU gate runs in fp32,
and upsampling to a non-2x size uses torch's nearest index rule.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from audioldm_tpu_torch.config import UNetConfig
from audioldm_tpu_torch.models.nn import ACT, Attention, group_norm, layer_norm, timestep_embedding
from audioldm_tpu_torch.utils.profiling import span


def upsample_nearest(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Nearest upsample of [B, C, H, W] to (th, tw) with the index rule
    ``src = dst * in // out`` (exact 2x when the sizes divide; diffusers
    passes the skip's size when they do not, e.g. 32 -> 63 latent frames)."""
    h, w = x.shape[-2:]
    hi = torch.arange(th, device=x.device) * h // th
    wi = torch.arange(tw, device=x.device) * w // tw
    return x[:, :, hi][:, :, :, wi]


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: Optional[int], groups: int, eps: float):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        if temb_ch:
            self.time_emb_proj = nn.Linear(temb_ch, out_ch)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None, act=ACT["silu"]) -> torch.Tensor:
        h = self.conv1(act(group_norm(x, self.norm1)))
        if temb is not None:
            h = h + self.time_emb_proj(act(temb))[:, :, None, None]
        h = self.conv2(act(group_norm(h, self.norm2)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * ACT["gelu"](gate.float()).to(h.dtype)


class FeedForward(nn.Module):
    """diffusers ``FeedForward`` with GEGLU: ``net = [GEGLU, Dropout, Linear]``."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Dropout(0.0), nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: Optional[int]):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, context_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None, lora=None, lora_scale: float = 1.0) -> torch.Tensor:
        x = x + self.attn1(layer_norm(x, self.norm1), None, lora, lora_scale)
        x = x + self.attn2(layer_norm(x, self.norm2), context, lora, lora_scale)  # context None: self-attention
        return x + self.ff(layer_norm(x, self.norm3))


class Transformer2DModel(nn.Module):
    """GroupNorm(eps 1e-6) -> 1x1 proj_in -> tokens -> blocks -> proj_out -> + residual."""

    def __init__(self, ch: int, heads: int, layers: int, context_dim: Optional[int], groups: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = nn.Conv2d(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(ch, heads, context_dim) for _ in range(layers)])
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None, lora=None, lora_scale: float = 1.0) -> torch.Tensor:
        b, c, h, w = x.shape
        res = x
        t = self.proj_in(group_norm(x, self.norm)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for blk in self.transformer_blocks:
            t = blk(t, context, lora, lora_scale)
        return self.proj_out(t.reshape(b, h, w, c).permute(0, 3, 1, 2)) + res


class _Sampler(nn.Module):
    """Holds the ``conv`` of a diffusers Downsample2D / Upsample2D."""

    def __init__(self, ch: int, stride: int, padding: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride, padding=padding)


class _Block(nn.Module):
    """A down or up block: ``resnets``, optional ``attentions`` and
    ``downsamplers``/``upsamplers``."""


class UNet2DConditionModel(nn.Module):
    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        if cfg.class_embed_type != "simple_projection":
            raise NotImplementedError(f"class_embed_type={cfg.class_embed_type!r}")
        self.cfg = cfg
        b0 = cfg.block_out_channels[0]
        temb = b0 * 4
        temb_cat = temb * 2 if cfg.class_embeddings_concat else temb
        g, eps, nl = cfg.norm_num_groups, cfg.norm_eps, cfg.transformer_layers_per_block
        ctx = cfg.cross_attention_dim
        self.conv_in = nn.Conv2d(cfg.in_channels, b0, 3, padding=1)
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = nn.Linear(b0, temb)
        self.time_embedding.linear_2 = nn.Linear(temb, temb)
        self.class_embedding = nn.Linear(cfg.projection_class_embeddings_input_dim, temb)

        self.down_blocks = nn.ModuleList()
        out_ch = b0
        for i, btype in enumerate(cfg.down_block_types):
            in_ch, out_ch = out_ch, cfg.block_out_channels[i]
            blk = _Block()
            blk.resnets = nn.ModuleList(
                [ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, temb_cat, g, eps) for j in range(cfg.layers_per_block)]
            )
            if "CrossAttn" in btype:
                blk.attentions = nn.ModuleList(
                    [Transformer2DModel(out_ch, cfg.num_heads(i), nl, ctx, g) for _ in range(cfg.layers_per_block)]
                )
            if i < len(cfg.down_block_types) - 1:
                blk.downsamplers = nn.ModuleList([_Sampler(out_ch, 2, cfg.downsample_padding)])
            self.down_blocks.append(blk)

        mid = cfg.block_out_channels[-1]
        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList([ResnetBlock2D(mid, mid, temb_cat, g, eps) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList(
            [Transformer2DModel(mid, cfg.num_heads(len(cfg.block_out_channels) - 1), nl, ctx, g)]
        )

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(cfg.block_out_channels))
        out_ch = rev[0]
        for i, btype in enumerate(cfg.up_block_types):
            prev_out, out_ch = out_ch, rev[i]
            in_ch = rev[min(i + 1, len(rev) - 1)]
            blk = _Block()
            blk.resnets = nn.ModuleList(
                [
                    ResnetBlock2D(
                        (prev_out if j == 0 else out_ch) + (in_ch if j == cfg.layers_per_block else out_ch),
                        out_ch, temb_cat, g, eps,
                    )
                    for j in range(cfg.layers_per_block + 1)
                ]
            )
            if "CrossAttn" in btype:
                heads = cfg.num_heads(len(rev) - 1 - i)
                blk.attentions = nn.ModuleList(
                    [Transformer2DModel(out_ch, heads, nl, ctx, g) for _ in range(cfg.layers_per_block + 1)]
                )
            if i < len(cfg.up_block_types) - 1:
                blk.upsamplers = nn.ModuleList([_Sampler(out_ch, 1, 1)])
            self.up_blocks.append(blk)

        self.conv_norm_out = nn.GroupNorm(g, b0, eps=eps)
        self.conv_out = nn.Conv2d(b0, cfg.out_channels, 3, padding=1)
        for name, m in self.named_modules():
            if isinstance(m, Attention):
                m.path = name  # the key prefix of its LoRA adapters
        # the names of the blocks' spans (utils/profiling.py), made once
        self.down_spans = tuple(f"unet.down.{i}" for i in range(len(self.down_blocks)))
        self.up_spans = tuple(f"unet.up.{i}" for i in range(len(self.up_blocks)))

    def forward(
        self, sample: torch.Tensor, timesteps: torch.Tensor, class_labels: torch.Tensor,
        encoder_hidden_states: Optional[torch.Tensor] = None, lora=None, lora_scale: float = 1.0,
    ) -> torch.Tensor:
        """``sample`` [B, C, H, W] latents, ``timesteps`` [B] (or a scalar),
        ``class_labels`` [B, 512] pooled text embedding -> eps [B, C, H, W].
        ``lora`` (``lora.adapter.LoRAAdapters``, keyed by module path, or an
        adapter bank's per-row gather, see ``models/nn.py Attention``) and
        ``lora_scale`` reach every ``Attention``: the unmerged adapter path
        that training differentiates and mixed serving batches run.

        Spans (``utils/profiling.py``): ``unet.in`` (the time and class
        embeddings, ``conv_in``), ``unet.down.{i}``, ``unet.mid``,
        ``unet.up.{i}``, ``unet.out`` (the last norm and ``conv_out``)."""
        cfg = self.cfg
        act = ACT[cfg.act_fn]
        dtype = sample.dtype
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])
        with span("unet.in"):
            t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0], cfg.flip_sin_to_cos,
                                       float(cfg.freq_shift)).to(dtype)
            emb = self.time_embedding.linear_2(act(self.time_embedding.linear_1(t_emb)))
            class_emb = self.class_embedding(class_labels.to(dtype))
            emb = torch.cat([emb, class_emb], dim=-1) if cfg.class_embeddings_concat else emb + class_emb
            sample = self.conv_in(sample)
        ctx = encoder_hidden_states
        skips = [sample]
        for blk, name in zip(self.down_blocks, self.down_spans):
            with span(name):
                for j, res in enumerate(blk.resnets):
                    sample = res(sample, emb, act)
                    if hasattr(blk, "attentions"):
                        sample = blk.attentions[j](sample, ctx, lora, lora_scale)
                    skips.append(sample)
                if hasattr(blk, "downsamplers"):
                    sample = blk.downsamplers[0].conv(sample)
                    skips.append(sample)

        with span("unet.mid"):
            sample = self.mid_block.resnets[0](sample, emb, act)
            sample = self.mid_block.attentions[0](sample, ctx, lora, lora_scale)
            sample = self.mid_block.resnets[1](sample, emb, act)

        for blk, name in zip(self.up_blocks, self.up_spans):
            with span(name):
                for j, res in enumerate(blk.resnets):
                    sample = res(torch.cat([sample, skips.pop()], dim=1), emb, act)
                    if hasattr(blk, "attentions"):
                        sample = blk.attentions[j](sample, ctx, lora, lora_scale)
                if hasattr(blk, "upsamplers"):
                    h, w = sample.shape[-2:]
                    th, tw = skips[-1].shape[-2:] if skips else (2 * h, 2 * w)
                    sample = blk.upsamplers[0].conv(upsample_nearest(sample, th, tw))

        with span("unet.out"):
            return self.conv_out(act(group_norm(sample, self.conv_norm_out)))
