"""CLAP audio tower: the HTSAT Swin transformer with fused mel input (port of
audioldm_tpu/models/clap_audio.py; transformers ``ClapAudioModelWithProjection``
module names, so the ``audio_model.*`` and ``audio_projection.*`` keys of a
``ClapModel`` state dict load with ``strict=True``).

BatchNorm over the mel bins, the mel-to-"image" reshape with align-corners
bicubic resizes, the fused patch embed (a 4x4 patchify of the whole mel, a
patchify of its three crops and attentional feature fusion), four Swin
stages (window attention with a relative position bias, shifted windows,
patch merging), LayerNorm, token-mean pooling and the two-layer projection.

Every convolution of the tower has its kernel equal to its stride (the
patchify) or is 1x1 (the fusion's), so each is a reshape and a
``torch.matmul``: no cuDNN call, so no TF32 setting reaches the tower, which
stays in fp32 as the JAX package's is (PyTorch's fp32 matmuls do not use
TF32 unless a caller turns it on). The window attention goes through
``models/nn.py sdpa`` with an additive mask (bias and shift mask), its
plain path: a 64-token window is far below the flash kernels' threshold.
The tables (relative position index, shift masks, resize matrices) are
built on the host, as the JAX package builds them; the stage geometry comes
from the config, since every input is resized to the model's.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from audioldm_tpu_torch.config import ClapAudioConfig
from audioldm_tpu_torch.models.nn import ACT, layer_norm, sdpa


@functools.lru_cache(maxsize=None)
def relative_position_index(window: int) -> np.ndarray:
    """Pairwise relative-position index inside a window, int64 ``[N, N]``
    with ``N = window**2`` (transformers' ``relative_position_index``)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1).astype(np.int64)


@functools.lru_cache(maxsize=None)
def shift_attn_mask(height: int, width: int, window: int, shift: int) -> Optional[np.ndarray]:
    """The shifted-window attention mask, float32 ``[num_windows, N, N]`` of
    0 and -100; None without a shift."""
    if shift == 0:
        return None
    img = np.zeros((height, width))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(height // window, window, width // window, window).transpose(0, 2, 1, 3).reshape(-1, window * window)
    return np.where(win[:, None, :] != win[:, :, None], -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def cubic_interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """The 1-D align-corners bicubic resize (Keys kernel, a = -0.75, edges
    clamped: torch's ``interpolate(mode="bicubic", align_corners=True)``) as
    a float32 matrix ``[n_out, n_in]``."""
    a = -0.75

    def k(x):
        x = abs(x)
        if x <= 1:
            return (a + 2) * x**3 - (a + 3) * x**2 + 1
        if x < 2:
            return a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a
        return 0.0

    w = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        src = i * (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
        f = int(np.floor(src))
        for j in range(f - 1, f + 3):
            w[i, min(max(j, 0), n_in - 1)] += k(src - j)
    return w.astype(np.float32)


def stage_windows(cfg: ClapAudioConfig) -> list[tuple[tuple[int, int], int, int]]:
    """``(resolution, window, shift of the odd blocks)`` of each stage: a
    stage whose resolution is at most the window attends over the whole
    resolution, unshifted (transformers' ``set_shift_and_window_size``)."""
    res = (cfg.spec_size // cfg.patch_size,) * 2
    out = []
    for _ in cfg.depths:
        window, shift = cfg.window_size, cfg.window_size // 2
        if min(res) <= window:
            window, shift = min(res), 0
        out.append((res, window, shift))
        res = ((res[0] + 1) // 2, (res[1] + 1) // 2)
    return out


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Inference-mode BatchNorm in fp32 over the last (channel) axis."""
    inv = torch.rsqrt(bn.running_var.float() + bn.eps)
    return ((x.float() - bn.running_mean.float()) * inv * bn.weight.float() + bn.bias.float()).to(x.dtype)


def patchify(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` (no padding, kernel = stride) over NHWC ``x`` as one matmul:
    NHWC ``[B, H // kh, W // kw, out]``; a remainder row or column is
    dropped, as the convolution drops it."""
    kh, kw = conv.kernel_size
    b, h, w, c = x.shape
    oh, ow = h // kh, w // kw
    x = x[:, : oh * kh, : ow * kw].reshape(b, oh, kh, ow, kw, c).permute(0, 1, 3, 5, 2, 4).reshape(b, oh, ow, c * kh * kw)
    return torch.matmul(x, conv.weight.reshape(conv.out_channels, -1).t()) + conv.bias


def conv1x1(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A 1x1 ``conv`` over NHWC ``x`` as one matmul."""
    return torch.matmul(x, conv.weight[:, :, 0, 0].t()) + conv.bias


class _Block(nn.Module):
    """A Swin block under transformers' ``ClapAudioLayer`` names, for one
    stage's ``resolution``, ``window`` and ``shift``. Its shift mask is a
    buffer that the state dict leaves out."""

    def __init__(self, cfg: ClapAudioConfig, dim: int, heads: int, resolution: tuple[int, int], window: int, shift: int):
        super().__init__()
        self.heads, self.resolution, self.window, self.shift = heads, resolution, window, shift
        hp, wp = (-(-r // window) * window for r in resolution)  # padded to whole windows
        mask = shift_attn_mask(hp, wp, window, shift)
        self.register_buffer("shift_mask", None if mask is None else torch.from_numpy(mask)[:, None], persistent=False)
        self.layernorm_before = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.attention = nn.Module()
        sa = self.attention.self = nn.Module()
        sa.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        sa.register_buffer("relative_position_index", torch.from_numpy(relative_position_index(window)))
        for name in ("query", "key", "value"):
            setattr(sa, name, nn.Linear(dim, dim, bias=cfg.qkv_bias))
        self.attention.output = nn.Module()
        self.attention.output.dense = nn.Linear(dim, dim)
        self.layernorm_after = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.intermediate = nn.Module()
        self.intermediate.dense = nn.Linear(dim, int(cfg.mlp_ratio * dim))
        self.output = nn.Module()
        self.output.dense = nn.Linear(int(cfg.mlp_ratio * dim), dim)

    def forward(self, x: torch.Tensor, act) -> torch.Tensor:
        """``x [B, H*W, C]``: pad to whole windows, roll, attend within each
        window (bias plus the shift mask), roll back, crop, then the MLP."""
        (height, width), window, shift = self.resolution, self.window, self.shift
        b, n, c = x.shape
        h = layer_norm(x, self.layernorm_before).reshape(b, height, width, c)
        pad_b, pad_r = (window - height % window) % window, (window - width % window) % window
        if pad_b or pad_r:
            h = nn.functional.pad(h, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = height + pad_b, width + pad_r
        if shift:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
        nh, nw, nwin, d = hp // window, wp // window, window * window, c // self.heads
        windows = h.reshape(b, nh, window, nw, window, c).permute(0, 1, 3, 2, 4, 5).reshape(b, nh * nw, nwin, c)

        sa = self.attention.self

        def split(t):  # [B, nW, N, C] -> [B, nW, heads, N, d]
            return t.reshape(b, nh * nw, nwin, self.heads, d).transpose(2, 3)

        bias = sa.relative_position_bias_table[sa.relative_position_index.reshape(-1)]
        mask = bias.reshape(nwin, nwin, self.heads).permute(2, 0, 1).float()  # [heads, N, N]
        if self.shift_mask is not None:
            mask = mask + self.shift_mask  # [nW, heads, N, N]
        out = sdpa(split(sa.query(windows)), split(sa.key(windows)), split(sa.value(windows)), mask)
        out = self.attention.output.dense(out.transpose(2, 3).reshape(b, nh * nw, nwin, c))
        out = out.reshape(b, nh, nw, window, window, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if shift:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        h = x + out[:, :height, :width].reshape(b, n, c)
        ff = act(self.intermediate.dense(layer_norm(h, self.layernorm_after)))
        return h + self.output.dense(ff)


class _Merge(nn.Module):
    """Patch merging under transformers' ``ClapAudioPatchMerging`` names."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim, eps=eps)

    def forward(self, x: torch.Tensor, resolution: tuple[int, int]) -> torch.Tensor:
        height, width = resolution
        b, _, c = x.shape
        x = x.reshape(b, height, width, c)
        if height % 2 or width % 2:
            x = nn.functional.pad(x, (0, 0, 0, width % 2, 0, height % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(layer_norm(x.reshape(b, -1, 4 * c), self.norm))


def _aff(ch: int, inter: int) -> nn.Module:
    """Attentional feature fusion under transformers' ``ClapAudioAFFBlock``
    names (the ReLUs and the pool hold no weights)."""
    m = nn.Module()
    m.local_att = nn.Sequential(nn.Conv2d(ch, inter, 1), nn.BatchNorm2d(inter), nn.ReLU(), nn.Conv2d(inter, ch, 1),
                                nn.BatchNorm2d(ch))
    m.global_att = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(ch, inter, 1), nn.BatchNorm2d(inter), nn.ReLU(),
                                 nn.Conv2d(inter, ch, 1), nn.BatchNorm2d(ch))
    return m


def fuse(m: nn.Module, hidden: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """Attentional feature fusion of NHWC ``hidden`` and ``residual``."""
    x = hidden + residual
    la, ga = m.local_att, m.global_att
    local = batch_norm(conv1x1(torch.relu(batch_norm(conv1x1(x, la[0]), la[1])), la[3]), la[4])
    g = x.mean(dim=(1, 2), keepdim=True)
    g = batch_norm(conv1x1(torch.relu(batch_norm(conv1x1(g, ga[1]), ga[2])), ga[4]), ga[5])
    w = torch.sigmoid(local + g)
    return 2.0 * hidden * w + 2.0 * residual * (1.0 - w)


def reshape_mel2img(x: torch.Tensor, cfg: ClapAudioConfig) -> torch.Tensor:
    """``[B, C, T, F]`` mel -> ``[B, C, F * ratio, T // ratio]`` "image"
    (transformers' ``reshape_mel2img``): time and then frequency resized up
    to the model's input by the align-corners bicubic matrices."""
    b, c, t, f = x.shape
    ratio = cfg.freq_ratio
    spec_w, spec_h = cfg.spec_size * ratio, cfg.spec_size // ratio
    if t > spec_w or f > spec_h:
        raise ValueError(f"mel ({t}x{f}) larger than model input ({spec_w}x{spec_h})")
    if t < spec_w:
        x = torch.matmul(torch.from_numpy(cubic_interp_matrix(t, spec_w)).to(x.device), x)
    if f < spec_h:
        x = torch.matmul(x, torch.from_numpy(cubic_interp_matrix(f, spec_h)).to(x.device).t())
    t2, f2 = x.shape[2], x.shape[3]
    x = x.reshape(b, c * ratio, t2 // ratio, f2).transpose(2, 3)
    return x.reshape(b, c, f2 * ratio, t2 // ratio)


class ClapAudioModelWithProjection(nn.Module):
    def __init__(self, cfg: ClapAudioConfig = ClapAudioConfig()):
        super().__init__()
        self.cfg = cfg
        ch, ps = cfg.patch_embeds_hidden_size, cfg.patch_size
        enc = nn.Module()
        enc.batch_norm = nn.BatchNorm2d(cfg.num_mel_bins)
        pe = enc.patch_embed = nn.Module()
        pe.proj = nn.Conv2d(cfg.patch_embed_input_channels, ch, ps, stride=ps)
        pe.norm = nn.LayerNorm(ch, eps=cfg.layer_norm_eps)
        if cfg.enable_fusion:
            pe.mel_conv2d = nn.Conv2d(cfg.patch_embed_input_channels, ch, (ps, 3 * ps), stride=(ps, 3 * ps))
            pe.fusion_model = _aff(ch, ch // cfg.aff_block_r)
        enc.layers = nn.ModuleList()
        for i, (depth, (res, window, shift)) in enumerate(zip(cfg.depths, stage_windows(cfg))):
            dim = ch * 2**i
            stage = nn.Module()
            stage.blocks = nn.ModuleList(_Block(cfg, dim, cfg.num_attention_heads[i], res, window, shift if j % 2 else 0)
                                         for j in range(depth))
            if i < len(cfg.depths) - 1:
                stage.downsample = _Merge(dim, cfg.layer_norm_eps)
            enc.layers.append(stage)
        enc.norm = nn.LayerNorm(ch * 2 ** (len(cfg.depths) - 1), eps=cfg.layer_norm_eps)
        self.audio_model = nn.Module()
        self.audio_model.audio_encoder = enc
        self.audio_projection = nn.Module()
        self.audio_projection.linear1 = nn.Linear(cfg.hidden_size, cfg.projection_dim)
        self.audio_projection.linear2 = nn.Linear(cfg.projection_dim, cfg.projection_dim)

    def forward(self, input_features: torch.Tensor, is_longer: Optional[torch.Tensor] = None) -> dict:
        """``input_features [B, 4, T, num_mel_bins]`` fused log-mels (``[B,
        1, T, bins]`` without fusion), ``is_longer`` bool ``[B]``. Both
        patch-embed paths run and each sample takes its own, with no branch
        (the JAX package's form). Returns ``{"audio_embeds",
        "pooler_output", "last_hidden_state"}``."""
        cfg = self.cfg
        enc = self.audio_model.audio_encoder
        pe = enc.patch_embed
        b = input_features.shape[0]
        x = reshape_mel2img(batch_norm(input_features, enc.batch_norm), cfg)  # [B, C, H, W]
        g = patchify(x[:, 0:1].permute(0, 2, 3, 1), pe.proj)  # NHWC [B, H/ps, W/ps, ch]
        if cfg.enable_fusion:
            if is_longer is None:
                is_longer = torch.zeros(b, dtype=torch.bool, device=x.device)
            local = patchify(x[:, 1:4].reshape(b * 3, 1, *x.shape[2:]).permute(0, 2, 3, 1), pe.mel_conv2d)
            _, h_, wl, cc = local.shape
            local = local.reshape(b, 3, h_, wl, cc).transpose(1, 2).reshape(b, h_, 3 * wl, cc)
            if 3 * wl < g.shape[2]:
                local = nn.functional.pad(local, (0, 0, 0, g.shape[2] - 3 * wl))
            g = torch.where(is_longer.reshape(b, 1, 1, 1).to(torch.bool), fuse(pe.fusion_model, g, local), g)
        h = g.reshape(b, -1, g.shape[-1])
        if cfg.enable_patch_layer_norm:
            h = layer_norm(h, pe.norm)
        act = ACT[cfg.hidden_act]
        for stage in enc.layers:
            for block in stage.blocks:
                h = block(h, act)
            if hasattr(stage, "downsample"):
                h = stage.downsample(h, stage.blocks[0].resolution)
        h = layer_norm(h, enc.norm)
        pooled = h.mean(dim=1)
        proj = self.audio_projection
        emb = proj.linear2(ACT[cfg.projection_hidden_act](proj.linear1(pooled)))
        return {"audio_embeds": emb, "pooler_output": pooled, "last_hidden_state": h}
