"""Plain float32 forms of the four models of audioldm-s-full-v2: the UNet
(with the unmerged LoRA path), the VAE, the HiFi-GAN vocoder and the CLAP
text tower.

They follow the published diffusers / transformers architectures of
``cvssp/audioldm-s-full-v2`` and carry the same parameter names, so one
state dict loads into them and into the program under test. Attention and
convolutions are plain (``ops.Arith``); nothing here imports the program.
Configurations are plain dicts: the ``unet``, ``vae``, ``vocoder`` and
``text_encoder`` groups of a ``portbench/configs/*.json`` file.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

ACT = {"silu": F.silu, "gelu": F.gelu, "relu": F.relu}


def group_norm(x, norm: nn.GroupNorm):
    b, c = x.shape[:2]
    xf = x.float().reshape(b, norm.num_groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = (xc * torch.rsqrt(var + norm.eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    return y * norm.weight.float().reshape(shape) + norm.bias.float().reshape(shape)


def layer_norm(x, norm: nn.LayerNorm):
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(), norm.eps)


def lin(m: nn.Linear, x):
    return m.ar.linear(x, m.weight, m.bias)


def conv2d(m: nn.Conv2d, x, pad=None):
    if pad is not None:
        x = F.pad(x, pad)
    return m.ar.conv(F.conv2d, x, m.weight, m.bias, stride=m.stride, padding=m.padding)


def conv1d(m: nn.Conv1d, x):
    return m.ar.conv(F.conv1d, x, m.weight, m.bias, stride=m.stride, padding=m.padding, dilation=m.dilation)


def timestep_embedding(t, dim: int, flip_sin_to_cos=True, shift=0.0, max_period=10000.0):
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / (half - shift)
    emb = torch.exp(exponent)[None, :] * t.float()[:, None]
    return torch.cat([emb.cos(), emb.sin()] if flip_sin_to_cos else [emb.sin(), emb.cos()], dim=-1)


def upsample_nearest(x, th: int, tw: int):
    h, w = x.shape[-2:]
    hi = torch.arange(th, device=x.device) * h // th
    wi = torch.arange(tw, device=x.device) * w // tw
    return x[:, :, hi][:, :, :, wi]


# ---------------------------------------------------------------- UNet
class Resnet(nn.Module):
    def __init__(self, cin, cout, temb, groups, eps):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        if temb:
            self.time_emb_proj = nn.Linear(temb, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x, temb=None):
        h = conv2d(self.conv1, F.silu(group_norm(x, self.norm1)))
        if temb is not None:
            h = h + lin(self.time_emb_proj, F.silu(temb))[:, :, None, None]
        h = conv2d(self.conv2, F.silu(group_norm(h, self.norm2)))
        if hasattr(self, "conv_shortcut"):
            x = conv2d(self.conv_shortcut, x)
        return x + h


class Attention(nn.Module):
    """Self-attention with bias-free q/k/v and the unmerged LoRA path
    ``W x + scale (x A) B`` of ``lora[path + ".to_q"]`` etc., where an entry
    is ``(A [in, r], B [r, out])`` or per-row ``(A [rows, in, r], B [rows,
    r, out])``."""

    path = ""

    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim), nn.Dropout(0.0)])

    def forward(self, x, lora=None, lora_scale=1.0):
        b, n, c = x.shape

        def proj(name, m):
            y = lin(m, x)
            entry = None if lora is None else lora.get(f"{self.path}.{name}")
            if entry is not None:
                y = y + lora_scale * self.ar.matmul(self.ar.matmul(x, entry[0]), entry[1])
            return y.view(b, n, self.heads, c // self.heads).transpose(1, 2)

        out = self.ar.attention(proj("to_q", self.to_q), proj("to_k", self.to_k), proj("to_v", self.to_v))
        return lin(self.to_out[0], out.transpose(1, 2).reshape(b, n, c))


class TransformerBlock(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.norm1, self.attn1 = nn.LayerNorm(dim), Attention(dim, heads)
        self.norm2, self.attn2 = nn.LayerNorm(dim), Attention(dim, heads)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = nn.Module()
        self.ff.net = nn.ModuleList([nn.Module(), nn.Dropout(0.0), nn.Linear(4 * dim, dim)])
        self.ff.net[0].proj = nn.Linear(dim, 8 * dim)

    def forward(self, x, lora, lora_scale):
        x = x + self.attn1(layer_norm(x, self.norm1), lora, lora_scale)
        x = x + self.attn2(layer_norm(x, self.norm2), lora, lora_scale)  # no context: self-attention
        h, gate = lin(self.ff.net[0].proj, layer_norm(x, self.norm3)).chunk(2, dim=-1)
        return x + lin(self.ff.net[2], h * F.gelu(gate))


class Transformer2D(nn.Module):
    def __init__(self, ch, heads, groups):
        super().__init__()
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = nn.Conv2d(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(ch, heads)])
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x, lora, lora_scale):
        b, c, h, w = x.shape
        t = conv2d(self.proj_in, group_norm(x, self.norm)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for blk in self.transformer_blocks:
            t = blk(t, lora, lora_scale)
        return conv2d(self.proj_out, t.reshape(b, h, w, c).permute(0, 3, 1, 2)) + x


def _sampler(ch, stride, padding):
    s = nn.Module()
    s.conv = nn.Conv2d(ch, ch, 3, stride=stride, padding=padding)
    return nn.ModuleList([s])


def _heads(cfg, level):
    ahd = cfg["attention_head_dim"]  # diffusers' legacy name: a head count
    return int(ahd[level]) if isinstance(ahd, (list, tuple)) else int(ahd)


class UNet(nn.Module):
    """UNet2DConditionModel as audioldm-s uses it: the pooled text
    embedding enters through the class embedding, concatenated onto the
    time embedding; attn2 self-attends."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        ch = list(cfg["block_out_channels"])
        b0, g, eps, lpb = ch[0], cfg["norm_num_groups"], cfg["norm_eps"], cfg["layers_per_block"]
        temb = b0 * 4
        tcat = 2 * temb
        self.conv_in = nn.Conv2d(cfg["in_channels"], b0, 3, padding=1)
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = nn.Linear(b0, temb)
        self.time_embedding.linear_2 = nn.Linear(temb, temb)
        self.class_embedding = nn.Linear(cfg["projection_class_embeddings_input_dim"], temb)
        self.down_blocks = nn.ModuleList()
        out = b0
        for i, kind in enumerate(cfg["down_block_types"]):
            cin, out = out, ch[i]
            blk = nn.Module()
            blk.resnets = nn.ModuleList([Resnet(cin if j == 0 else out, out, tcat, g, eps) for j in range(lpb)])
            if "CrossAttn" in kind:
                blk.attentions = nn.ModuleList([Transformer2D(out, _heads(cfg, i), g) for _ in range(lpb)])
            if i < len(ch) - 1:
                blk.downsamplers = _sampler(out, 2, cfg["downsample_padding"])
            self.down_blocks.append(blk)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([Resnet(ch[-1], ch[-1], tcat, g, eps) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList([Transformer2D(ch[-1], _heads(cfg, len(ch) - 1), g)])
        self.up_blocks = nn.ModuleList()
        rev = ch[::-1]
        out = rev[0]
        for i, kind in enumerate(cfg["up_block_types"]):
            prev, out = out, rev[i]
            skip_in = rev[min(i + 1, len(rev) - 1)]
            blk = nn.Module()
            blk.resnets = nn.ModuleList([
                Resnet((prev if j == 0 else out) + (skip_in if j == lpb else out), out, tcat, g, eps) for j in range(lpb + 1)
            ])
            if "CrossAttn" in kind:
                blk.attentions = nn.ModuleList([Transformer2D(out, _heads(cfg, len(rev) - 1 - i), g) for _ in range(lpb + 1)])
            if i < len(rev) - 1:
                blk.upsamplers = _sampler(out, 1, 1)
            self.up_blocks.append(blk)
        self.conv_norm_out = nn.GroupNorm(g, b0, eps=eps)
        self.conv_out = nn.Conv2d(b0, cfg["out_channels"], 3, padding=1)
        for name, m in self.named_modules():
            if isinstance(m, Attention):
                m.path = name

    def forward(self, x, t, class_labels, lora=None, lora_scale=1.0):
        cfg = self.cfg
        te = timestep_embedding(t, cfg["block_out_channels"][0], cfg["flip_sin_to_cos"], float(cfg["freq_shift"]))
        emb = lin(self.time_embedding.linear_2, F.silu(lin(self.time_embedding.linear_1, te)))
        emb = torch.cat([emb, lin(self.class_embedding, class_labels)], dim=-1)
        h = conv2d(self.conv_in, x)
        skips = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, emb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, lora, lora_scale)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = conv2d(blk.downsamplers[0].conv, h)
                skips.append(h)
        h = self.mid_block.resnets[0](h, emb)
        h = self.mid_block.attentions[0](h, lora, lora_scale)
        h = self.mid_block.resnets[1](h, emb)
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), emb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, lora, lora_scale)
            if hasattr(blk, "upsamplers"):
                th, tw = skips[-1].shape[-2:]
                h = conv2d(blk.upsamplers[0].conv, upsample_nearest(h, th, tw))
        return conv2d(self.conv_out, F.silu(group_norm(h, self.conv_norm_out)))


# ---------------------------------------------------------------- VAE
class VAEAttention(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q, self.to_k, self.to_v = nn.Linear(ch, ch), nn.Linear(ch, ch), nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch), nn.Dropout(0.0)])

    def forward(self, x):
        b, c, h, w = x.shape
        t = group_norm(x, self.group_norm).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = (lin(p, t)[:, None] for p in (self.to_q, self.to_k, self.to_v))
        t = lin(self.to_out[0], self.ar.attention(q, k, v)[:, 0])
        return x + t.transpose(1, 2).reshape(b, c, h, w)


class VAEMid(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.resnets = nn.ModuleList([Resnet(ch, ch, None, groups, 1e-6) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class VAE(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        b, g, lpb, lc = list(cfg["block_out_channels"]), cfg["norm_num_groups"], cfg["layers_per_block"], cfg["latent_channels"]
        enc = nn.Module()
        enc.conv_in = nn.Conv2d(cfg["in_channels"], b[0], 3, padding=1)
        enc.down_blocks = nn.ModuleList()
        out = b[0]
        for i in range(len(b)):
            cin, out = out, b[i]
            blk = nn.Module()
            blk.resnets = nn.ModuleList([Resnet(cin if j == 0 else out, out, None, g, 1e-6) for j in range(lpb)])
            if i < len(b) - 1:
                blk.downsamplers = _sampler(out, 2, 0)
            enc.down_blocks.append(blk)
        enc.mid_block = VAEMid(b[-1], g)
        enc.conv_norm_out = nn.GroupNorm(g, b[-1], eps=1e-6)
        enc.conv_out = nn.Conv2d(b[-1], 2 * lc, 3, padding=1)
        self.encoder = enc
        dec = nn.Module()
        dec.conv_in = nn.Conv2d(lc, b[-1], 3, padding=1)
        dec.mid_block = VAEMid(b[-1], g)
        dec.up_blocks = nn.ModuleList()
        rev = b[::-1]
        out = rev[0]
        for i in range(len(rev)):
            cin, out = out, rev[i]
            blk = nn.Module()
            blk.resnets = nn.ModuleList([Resnet(cin if j == 0 else out, out, None, g, 1e-6) for j in range(lpb + 1)])
            if i < len(rev) - 1:
                blk.upsamplers = _sampler(out, 1, 1)
            dec.up_blocks.append(blk)
        dec.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=1e-6)
        dec.conv_out = nn.Conv2d(rev[-1], cfg["out_channels"], 3, padding=1)
        self.decoder = dec
        self.quant_conv = nn.Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = nn.Conv2d(lc, lc, 1)

    def encode(self, x):
        """Mel [B, 1, T, F] -> (mean, logvar clipped to [-30, 20])."""
        enc = self.encoder
        h = conv2d(enc.conv_in, x)
        for blk in enc.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "downsamplers"):
                h = conv2d(blk.downsamplers[0].conv, h, pad=(0, 1, 0, 1))
        h = enc.mid_block(h)
        h = conv2d(enc.conv_out, F.silu(group_norm(h, enc.conv_norm_out)))
        mean, logvar = conv2d(self.quant_conv, h).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        dec = self.decoder
        h = dec.mid_block(conv2d(dec.conv_in, conv2d(self.post_quant_conv, z)))
        for blk in dec.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                hh, ww = h.shape[-2:]
                h = conv2d(blk.upsamplers[0].conv, upsample_nearest(h, 2 * hh, 2 * ww))
        return conv2d(dec.conv_out, F.silu(group_norm(h, dec.conv_norm_out)))


# ---------------------------------------------------------------- vocoder
class Vocoder(nn.Module):
    """SpeechT5HifiGan: normalise, conv_pre, transposed-conv upsamplers each
    followed by the mean of its resblocks, leaky 0.01, conv_post, tanh."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        c0 = cfg["upsample_initial_channel"]
        self.conv_pre = nn.Conv1d(cfg["model_in_dim"], c0, 7, padding=3)
        self.upsampler = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (rate, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
            ch = c0 // 2 ** (i + 1)
            self.upsampler.append(nn.ConvTranspose1d(c0 // 2**i, ch, k, stride=rate, padding=(k - rate) // 2))
            for ks, dils in zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]):
                blk = nn.Module()
                blk.convs1 = nn.ModuleList([nn.Conv1d(ch, ch, ks, dilation=d, padding=(ks * d - d) // 2) for d in dils])
                blk.convs2 = nn.ModuleList([nn.Conv1d(ch, ch, ks, padding=(ks - 1) // 2) for _ in dils])
                self.resblocks.append(blk)
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)
        self.register_buffer("mean", torch.zeros(cfg["model_in_dim"]))
        self.register_buffer("scale", torch.ones(cfg["model_in_dim"]))

    def forward(self, mel):
        """mel [B, T, F] -> waveform [B, T * hop]."""
        cfg, slope = self.cfg, self.cfg["leaky_relu_slope"]
        x = mel.float()
        if cfg["normalize_before"]:
            x = (x - self.mean) / self.scale
        h = conv1d(self.conv_pre, x.transpose(1, 2))
        nk = len(cfg["resblock_kernel_sizes"])
        for i, up in enumerate(self.upsampler):
            h = self.ar.conv(F.conv_transpose1d, F.leaky_relu(h, slope), up.weight, up.bias,
                             stride=up.stride, padding=up.padding)
            acc = 0.0
            for blk in self.resblocks[i * nk : (i + 1) * nk]:
                r = h
                for c1, c2 in zip(blk.convs1, blk.convs2):
                    r = r + conv1d(c2, F.leaky_relu(conv1d(c1, F.leaky_relu(r, slope)), slope))
                acc = acc + r
            h = acc / nk
        return torch.tanh(conv1d(self.conv_post, F.leaky_relu(h, 0.01)))[:, 0]


# ---------------------------------------------------------------- text tower
class TextTower(nn.Module):
    """ClapTextModelWithProjection: RoBERTa, the pooler, a 2-layer MLP."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        hs, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        tm = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.word_embeddings = nn.Embedding(cfg["vocab_size"], hs)
        tm.embeddings.position_embeddings = nn.Embedding(cfg["max_position_embeddings"], hs)
        tm.embeddings.token_type_embeddings = nn.Embedding(cfg["type_vocab_size"], hs)
        tm.embeddings.LayerNorm = nn.LayerNorm(hs, eps=eps)
        tm.encoder = nn.Module()
        tm.encoder.layer = nn.ModuleList()
        for _ in range(cfg["num_hidden_layers"]):
            lay = nn.Module()
            lay.attention = nn.Module()
            lay.attention.self = nn.Module()
            for name in ("query", "key", "value"):
                setattr(lay.attention.self, name, nn.Linear(hs, hs))
            lay.attention.output = nn.Module()
            lay.attention.output.dense = nn.Linear(hs, hs)
            lay.attention.output.LayerNorm = nn.LayerNorm(hs, eps=eps)
            lay.intermediate = nn.Module()
            lay.intermediate.dense = nn.Linear(hs, cfg["intermediate_size"])
            lay.output = nn.Module()
            lay.output.dense = nn.Linear(cfg["intermediate_size"], hs)
            lay.output.LayerNorm = nn.LayerNorm(hs, eps=eps)
            tm.encoder.layer.append(lay)
        tm.pooler = nn.Module()
        tm.pooler.dense = nn.Linear(hs, hs)
        self.text_model = tm
        self.text_projection = nn.Module()
        self.text_projection.linear1 = nn.Linear(hs, cfg["projection_dim"])
        self.text_projection.linear2 = nn.Linear(cfg["projection_dim"], cfg["projection_dim"])

    def forward(self, ids, mask):
        """Token ids and mask [B, L] -> the L2-normalised projected pooled
        embedding [B, projection_dim]."""
        cfg = self.cfg
        ids, mask = ids.long(), mask.long()
        pad = cfg["pad_token_id"]
        keep = (ids != pad).long()
        pos = torch.cumsum(keep, dim=1) * keep + pad
        e = self.text_model.embeddings
        h = layer_norm(e.word_embeddings.weight.float()[ids] + e.position_embeddings.weight.float()[pos]
                       + e.token_type_embeddings.weight.float()[torch.zeros_like(ids)], e.LayerNorm)
        ext = (1.0 - mask.float())[:, None, None, :] * -1e9
        nh, hs = cfg["num_attention_heads"], cfg["hidden_size"]
        b, n, _ = h.shape
        for lay in self.text_model.encoder.layer:
            sa = lay.attention.self
            q, k, v = (lin(p, h).view(b, n, nh, hs // nh).transpose(1, 2) for p in (sa.query, sa.key, sa.value))
            a = self.ar.attention(q, k, v, ext).transpose(1, 2).reshape(b, n, hs)
            h = layer_norm(lin(lay.attention.output.dense, a) + h, lay.attention.output.LayerNorm)
            inter = F.gelu(lin(lay.intermediate.dense, h))
            h = layer_norm(lin(lay.output.dense, inter) + h, lay.output.LayerNorm)
        pooled = torch.tanh(lin(self.text_model.pooler.dense, h[:, 0]))
        p = self.text_projection
        emb = lin(p.linear2, F.relu(lin(p.linear1, pooled)))
        return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)


MODELS = {"unet": UNet, "vae": VAE, "vocoder": Vocoder, "text_encoder": TextTower}
