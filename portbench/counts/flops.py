"""Analytic FLOP counts of the audioldm-s workloads: the matmul-class work
(convolutions, linears, attention products) of text-to-audio generation and
of one LoRA training step, 2 M K N a contraction, from the configuration's
sizes. A copy of the program's ``audioldm_tpu_torch/utils/flops.py`` count
(its breakdown by category kept), taking the configuration groups of a
``portbench/configs/*.json`` file as attribute bags; a test holds the two
equal.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from types import SimpleNamespace


def _heads(cfg, level: int) -> int:
    ahd = cfg.attention_head_dim  # diffusers' legacy name: a head count
    return int(ahd[level]) if isinstance(ahd, (list, tuple)) else int(ahd)


def groups(cfg: dict) -> dict:
    """The ``unet``, ``vae``, ``vocoder`` and ``text_encoder`` groups of a
    configuration as attribute bags, for the counts below."""
    return {k: SimpleNamespace(**cfg[k]) for k in ("unet", "vae", "vocoder", "text_encoder")}

@dataclass
class FlopCount:
    """Accumulator; all values in FLOPs (multiply-add = 2)."""

    useful: float = 0.0
    by_category: dict = field(default_factory=dict)

    def matmul(self, m: int, k: int, n: int, category: str = "other", count: int = 1) -> None:
        u = 2.0 * m * k * n * count
        self.useful += u
        self.by_category[category] = self.by_category.get(category, 0.0) + u

    def add(self, other: "FlopCount", scale: float = 1.0) -> None:
        self.useful += other.useful * scale
        for cat, u in other.by_category.items():
            self.by_category[cat] = self.by_category.get(cat, 0.0) + u * scale

    def conv2d(self, b, h, w, cin, cout, k=3, stride=1, category="conv"):
        ho, wo = h // stride, w // stride
        # as an implicit GEMM: M = spatial outputs, K = k*k*cin taps, N = cout
        self.matmul(b * ho * wo, k * k * cin, cout, category)

    def conv1d(self, b, t_out, cin, cout, k, category="conv"):
        self.matmul(b * t_out, k * cin, cout, category)

    def linear(self, m, din, dout, category="other"):
        self.matmul(m, din, dout, category)

    def attention(self, b, heads, n, c, category_prefix="attention"):
        """Full MHA over [B, N, C] with `heads` heads (d = C/heads):
        q/k/v/out projections + per-head QK^T and AV einsums."""
        d = c // heads
        for _ in range(4):
            self.linear(b * n, c, c, category=f"{category_prefix}_proj")
        # QK^T: per (b, head): [N, d] @ [d, N]
        self.matmul(b * heads * n, d, n, category=f"{category_prefix}_qk_av")
        # AV:   per (b, head): [N, N] @ [N, d]
        self.matmul(b * heads * n, n, d, category=f"{category_prefix}_qk_av")


# ---------------------------------------------------------------------------
# UNet — mirrors models/unet.py block for block
# ---------------------------------------------------------------------------


def _resnet_flops(fc: FlopCount, b, h, w, cin, cout, temb_ch):
    fc.conv2d(b, h, w, cin, cout, k=3)
    fc.linear(b, temb_ch, cout, category="other")  # time_emb_proj
    fc.conv2d(b, h, w, cout, cout, k=3)
    if cin != cout:
        fc.conv2d(b, h, w, cin, cout, k=1)


def _transformer2d_flops(fc: FlopCount, b, h, w, c, heads, num_layers):
    n = h * w
    fc.conv2d(b, h, w, c, c, k=1)  # proj_in
    for _ in range(num_layers):
        fc.attention(b, heads, n, c)  # attn1
        fc.attention(b, heads, n, c)  # attn2 (context=None -> self)
        # GEGLU FF: [N, C] -> [N, 8C] then [N, 4C] -> [N, C]
        fc.linear(b * n, c, 8 * c, category="ff")
        fc.linear(b * n, 4 * c, c, category="ff")
    fc.conv2d(b, h, w, c, c, k=1)  # proj_out


def unet_step_flops(cfg, batch: int, h: int, w: int) -> FlopCount:
    """One epsilon prediction at latent resolution [batch, h, w, in_channels].
    For the flagship 10.24 s clip with CFG folded: batch=2, h=256, w=16."""
    fc = FlopCount()
    b0 = cfg.block_out_channels[0]
    temb = b0 * 4
    temb_cat = temb * 2 if cfg.class_embeddings_concat else temb
    tl = cfg.transformer_layers_per_block

    # time + class embedding MLPs (per step; tiny)
    fc.linear(batch, b0, temb)
    fc.linear(batch, temb, temb)
    if cfg.class_embed_type == "simple_projection":
        fc.linear(batch, cfg.projection_class_embeddings_input_dim, temb)

    fc.conv2d(batch, h, w, cfg.in_channels, b0, k=3)

    # down path
    ch = b0
    hh, ww = h, w
    for i, bt in enumerate(cfg.down_block_types):
        cin, ch = ch, cfg.block_out_channels[i]
        heads = _heads(cfg, i)
        for j in range(cfg.layers_per_block):
            _resnet_flops(fc, batch, hh, ww, cin if j == 0 else ch, ch, temb_cat)
            if "CrossAttn" in bt:
                _transformer2d_flops(fc, batch, hh, ww, ch, heads, tl)
        if i != len(cfg.down_block_types) - 1:
            fc.conv2d(batch, hh, ww, ch, ch, k=3, stride=2)
            hh, ww = hh // 2, ww // 2

    # mid
    mid_ch = cfg.block_out_channels[-1]
    mid_heads = _heads(cfg, len(cfg.block_out_channels) - 1)
    _resnet_flops(fc, batch, hh, ww, mid_ch, mid_ch, temb_cat)
    _transformer2d_flops(fc, batch, hh, ww, mid_ch, mid_heads, tl)
    _resnet_flops(fc, batch, hh, ww, mid_ch, mid_ch, temb_cat)

    # up path (skip concat widens resnet inputs — the model's own walk)
    rev = list(reversed(cfg.block_out_channels))
    out_ch = rev[0]
    for i, bt in enumerate(cfg.up_block_types):
        prev_out, out_ch = out_ch, rev[i]
        in_ch = rev[min(i + 1, len(rev) - 1)]
        heads = _heads(cfg, len(rev) - 1 - i)
        for j in range(cfg.layers_per_block + 1):
            skip_ch = in_ch if j == cfg.layers_per_block else out_ch
            res_in = prev_out if j == 0 else out_ch
            _resnet_flops(fc, batch, hh, ww, res_in + skip_ch, out_ch, temb_cat)
            if "CrossAttn" in bt:
                _transformer2d_flops(fc, batch, hh, ww, out_ch, heads, tl)
        if i != len(cfg.up_block_types) - 1:
            hh, ww = hh * 2, ww * 2
            fc.conv2d(batch, hh, ww, out_ch, out_ch, k=3)

    fc.conv2d(batch, hh, ww, b0, cfg.out_channels, k=3)
    return fc


# ---------------------------------------------------------------------------
# VAE — mirrors models/vae.py encode/decode
# ---------------------------------------------------------------------------


def _vae_mid_flops(fc: FlopCount, b, h, w, c):
    _vae_resnet = lambda cin, cout: _vae_resnet_flops(fc, b, h, w, cin, cout)
    _vae_resnet(c, c)
    n = h * w
    for _ in range(4):  # to_q/k/v/out, single head
        fc.linear(b * n, c, c, category="attention_proj")
    fc.matmul(b * n, c, n, category="attention_qk_av")
    fc.matmul(b * n, n, c, category="attention_qk_av")
    _vae_resnet(c, c)


def _vae_resnet_flops(fc: FlopCount, b, h, w, cin, cout):
    fc.conv2d(b, h, w, cin, cout, k=3)
    fc.conv2d(b, h, w, cout, cout, k=3)
    if cin != cout:
        fc.conv2d(b, h, w, cin, cout, k=1)


def vae_encode_flops(cfg, batch: int, h: int, w: int) -> FlopCount:
    """[batch, h, w, in_channels] mel -> latent distribution."""
    fc = FlopCount()
    bch = cfg.block_out_channels
    fc.conv2d(batch, h, w, cfg.in_channels, bch[0], k=3)
    ch, hh, ww = bch[0], h, w
    for i in range(len(bch)):
        cin, ch = ch, bch[i]
        for j in range(cfg.layers_per_block):
            _vae_resnet_flops(fc, batch, hh, ww, cin if j == 0 else ch, ch)
        if i < len(bch) - 1:
            fc.conv2d(batch, hh, ww, ch, ch, k=3, stride=2)
            hh, ww = hh // 2, ww // 2
    _vae_mid_flops(fc, batch, hh, ww, bch[-1])
    fc.conv2d(batch, hh, ww, bch[-1], 2 * cfg.latent_channels, k=3)
    fc.conv2d(batch, hh, ww, 2 * cfg.latent_channels, 2 * cfg.latent_channels, k=1)
    return fc


def vae_decode_flops(cfg, batch: int, h: int, w: int) -> FlopCount:
    """[batch, h, w, latent_channels] latents -> [batch, 4h, 4w, 1] mel."""
    fc = FlopCount()
    rev = list(reversed(cfg.block_out_channels))
    fc.conv2d(batch, h, w, cfg.latent_channels, cfg.latent_channels, k=1)
    fc.conv2d(batch, h, w, cfg.latent_channels, rev[0], k=3)
    _vae_mid_flops(fc, batch, h, w, rev[0])
    ch, hh, ww = rev[0], h, w
    for i in range(len(rev)):
        cin, ch = ch, rev[i]
        for j in range(cfg.layers_per_block + 1):
            _vae_resnet_flops(fc, batch, hh, ww, cin if j == 0 else ch, ch)
        if i < len(rev) - 1:
            hh, ww = hh * 2, ww * 2
            fc.conv2d(batch, hh, ww, ch, ch, k=3)
    fc.conv2d(batch, hh, ww, rev[-1], cfg.out_channels, k=3)
    return fc


# ---------------------------------------------------------------------------
# Vocoder — mirrors models/vocoder.py
# ---------------------------------------------------------------------------


def vocoder_flops(cfg, batch: int, t: int) -> FlopCount:
    """[batch, t, 64] mel -> [batch, t*160] waveform."""
    fc = FlopCount()
    fc.conv1d(batch, t, cfg.model_in_dim, cfg.upsample_initial_channel, 7)
    tt = t
    for i, (rate, ksize) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        in_ch = cfg.upsample_initial_channel // (2**i)
        out_ch = cfg.upsample_initial_channel // (2 ** (i + 1))
        # transposed conv: every input contributes to ksize outputs; as a
        # GEMM the contraction is ceil(ksize/rate) taps per output phase
        fc.matmul(batch * tt * rate, math.ceil(ksize / rate) * in_ch, out_ch, category="conv")
        tt *= rate
        for k, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            for _ in dils:
                fc.conv1d(batch, tt, out_ch, out_ch, k)  # convs1 (dilated)
                fc.conv1d(batch, tt, out_ch, out_ch, k)  # convs2
    fc.conv1d(batch, tt, out_ch, 1, 7)
    return fc


# ---------------------------------------------------------------------------
# CLAP text tower — mirrors models/clap_text.py (RoBERTa + projection)
# ---------------------------------------------------------------------------


def clap_text_flops(cfg, batch: int, seqlen: int) -> FlopCount:
    fc = FlopCount()
    c, ff = cfg.hidden_size, cfg.intermediate_size
    for _ in range(cfg.num_hidden_layers):
        fc.attention(batch, cfg.num_attention_heads, seqlen, c)
        fc.linear(batch * seqlen, c, ff, category="ff")
        fc.linear(batch * seqlen, ff, c, category="ff")
    # 2-layer projection MLP on the pooled token
    fc.linear(batch, c, cfg.projection_dim)
    fc.linear(batch, cfg.projection_dim, cfg.projection_dim)
    return fc


# ---------------------------------------------------------------------------
# Workloads
# ---------------------------------------------------------------------------


def pipeline_flops(
    unet_cfg,
    vae_cfg,
    voc_cfg,
    text_cfg,
    steps: int = 50,
    batch: int = 1,
    latent_h: int = 256,
    latent_w: int = 16,
    seqlen: int = 512,
) -> dict:
    """Full text->audio generation: text encode (cond + uncond) -> steps x
    CFG-folded UNet -> VAE decode -> vocoder. Returns a dict of per-stage
    FlopCounts plus 'total'."""
    stages = {
        "text_encode": clap_text_flops(text_cfg, 2 * batch, seqlen),
        "unet_denoise": _scaled(unet_step_flops(unet_cfg, 2 * batch, latent_h, latent_w), steps),
        "vae_decode": vae_decode_flops(vae_cfg, batch, latent_h, latent_w),
        "vocoder": vocoder_flops(voc_cfg, batch, 4 * latent_h),
    }
    total = FlopCount()
    for s in stages.values():
        total.add(s)
    stages["total"] = total
    return stages


def train_step_flops(
    unet_cfg,
    vae_cfg,
    text_cfg,
    batch: int = 2,
    mel_t: int = 1024,
    mel_f: int = 64,
    seqlen: int = 512,
    remat: bool = False,
) -> dict:
    """One LoRA train step: VAE encode fwd (no grad) + text encode fwd (no grad) + UNet
    fwd + backward. Only LoRA A/B receive weight gradients, so the backward
    is ~1x the forward (one dX matmul per frozen matmul; the dW terms exist
    only for the rank-r adapters and are negligible). remat adds one extra
    UNet forward."""
    unet_fwd = unet_step_flops(unet_cfg, batch, mel_t // 4, mel_f // 4)
    bwd_scale = 2.0 if remat else 1.0  # dx pass (+ recompute fwd under remat)
    stages = {
        "vae_encode": vae_encode_flops(vae_cfg, batch, mel_t, mel_f),
        "text_encode": clap_text_flops(text_cfg, batch, seqlen),
        "unet_fwd": unet_fwd,
        "unet_bwd": _scaled(unet_fwd, bwd_scale),
    }
    total = FlopCount()
    for s in stages.values():
        total.add(s)
    stages["total"] = total
    return stages


def _scaled(fc: FlopCount, scale: float) -> FlopCount:
    out = FlopCount()
    out.add(fc, scale)
    return out


