"""AutoencoderKL, the mel-spectrogram VAE (port of audioldm_tpu/models/vae.py).

``decode``: post_quant_conv, the decoder with its single-head mid-block
attention, nearest-2x upsamplers and conv_out. ``encode``: the encoder with
its (0, 1)-padded stride-2 downsamplers, quant_conv and the diagonal
Gaussian ``LatentDist`` that training samples from.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from audioldm_tpu_torch.config import VAEConfig
from audioldm_tpu_torch.kernels.flash_attention import sdpa_plain
from audioldm_tpu_torch.models.nn import ACT, group_norm
from audioldm_tpu_torch.models.unet import ResnetBlock2D, _Block, _Sampler, upsample_nearest


class VAEAttention(nn.Module):
    """Mid-block attention: biased q/k/v, one head of dim C, own GroupNorm
    (eps 1e-6), residual. d = C = 512 is above the flash kernel's head-dim
    limit, so it is plain matmul attention as in the JAX package."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch), nn.Dropout(0.0)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = group_norm(x, self.group_norm).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = (p(t)[:, None] for p in (self.to_q, self.to_k, self.to_v))
        t = self.to_out[0](sdpa_plain(q, k, v)[:, 0])
        return x + t.transpose(1, 2).reshape(b, c, h, w)


class _Mid(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, None, groups, 1e-6) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x: torch.Tensor, act) -> torch.Tensor:
        x = self.resnets[0](x, None, act)
        x = self.attentions[0](x)
        return self.resnets[1](x, None, act)


class LatentDist(NamedTuple):
    """Diagonal Gaussian over latents ``[B, C, T/4, F/4]``."""

    mean: torch.Tensor
    logvar: torch.Tensor

    def sample(self, generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mean + exp(logvar / 2) * eps`` with ``eps`` given, or drawn
        from ``generator`` (on the generator's device, then moved)."""
        if eps is None:
            dev = generator.device if generator is not None else self.mean.device
            eps = torch.randn(self.mean.shape, generator=generator, device=dev, dtype=torch.float32)
        return self.mean + torch.exp(0.5 * self.logvar) * eps.to(self.mean)

    @property
    def mode(self) -> torch.Tensor:
        return self.mean


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        b, g = cfg.block_out_channels, cfg.norm_num_groups

        enc = nn.Module()
        enc.conv_in = nn.Conv2d(cfg.in_channels, b[0], 3, padding=1)
        enc.down_blocks = nn.ModuleList()
        out_ch = b[0]
        for i in range(len(b)):
            in_ch, out_ch = out_ch, b[i]
            blk = _Block()
            blk.resnets = nn.ModuleList(
                [ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, None, g, 1e-6) for j in range(cfg.layers_per_block)]
            )
            if i < len(b) - 1:
                blk.downsamplers = nn.ModuleList([_Sampler(out_ch, 2, 0)])
            enc.down_blocks.append(blk)
        enc.mid_block = _Mid(b[-1], g)
        enc.conv_norm_out = nn.GroupNorm(g, b[-1], eps=1e-6)
        enc.conv_out = nn.Conv2d(b[-1], 2 * cfg.latent_channels, 3, padding=1)
        self.encoder = enc

        dec = nn.Module()
        dec.conv_in = nn.Conv2d(cfg.latent_channels, b[-1], 3, padding=1)
        dec.mid_block = _Mid(b[-1], g)
        dec.up_blocks = nn.ModuleList()
        rev = list(reversed(b))
        out_ch = rev[0]
        for i in range(len(rev)):
            in_ch, out_ch = out_ch, rev[i]
            blk = _Block()
            blk.resnets = nn.ModuleList(
                [ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, None, g, 1e-6) for j in range(cfg.layers_per_block + 1)]
            )
            if i < len(rev) - 1:
                blk.upsamplers = nn.ModuleList([_Sampler(out_ch, 1, 1)])
            dec.up_blocks.append(blk)
        dec.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=1e-6)
        dec.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)
        self.decoder = dec

        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    def encode(self, x: torch.Tensor) -> LatentDist:
        """Mel [B, 1, T, F] -> diagonal Gaussian over [B, C, T/4, F/4].
        diffusers' ``Downsample2D(padding=0)`` pads (0, 1) on each spatial
        dim before its stride-2 conv; logvar is clipped to [-30, 20]."""
        act = ACT[self.cfg.act_fn]
        enc = self.encoder
        h = enc.conv_in(x)
        for blk in enc.down_blocks:
            for res in blk.resnets:
                h = res(h, None, act)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = enc.mid_block(h, act)
        h = enc.conv_out(act(group_norm(h, enc.conv_norm_out)))
        mean, logvar = self.quant_conv(h).chunk(2, dim=1)
        return LatentDist(mean, logvar.clamp(-30.0, 20.0))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents [B, C, T/4, F/4] -> mel [B, 1, T, F]."""
        act = ACT[self.cfg.act_fn]
        dec = self.decoder
        h = dec.conv_in(self.post_quant_conv(z))
        h = dec.mid_block(h, act)
        for blk in dec.up_blocks:
            for res in blk.resnets:
                h = res(h, None, act)
            if hasattr(blk, "upsamplers"):
                hh, ww = h.shape[-2:]
                h = blk.upsamplers[0].conv(upsample_nearest(h, 2 * hh, 2 * ww))
        return dec.conv_out(act(group_norm(h, dec.conv_norm_out)))
