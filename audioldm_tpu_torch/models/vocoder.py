"""HiFi-GAN vocoder, SpeechT5HifiGan-compatible (port of
audioldm_tpu/models/vocoder.py), fp32 throughout.

mel [B, T, model_in_dim] -> optional mean/scale normalisation -> conv_pre ->
transposed-conv upsamplers (rates multiply to the hop) each followed by a
multi-receptive-field stage (mean of resblocks, leaky 0.1) -> leaky 0.01 ->
conv_post -> tanh. Routing as in the JAX package: from the first stage index
at which every remaining stage is supported by kernel K2, the stages run
through ``mrf_stage`` and the last one fuses conv_post and tanh into its
epilogue; the other stages and the plain tail use ``F.conv1d``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from audioldm_tpu_torch.config import VocoderConfig
from audioldm_tpu_torch.kernels import mrf_conv


class HifiGanResidualBlock(nn.Module):
    def __init__(self, ch: int, kernel_size: int, dilations):
        super().__init__()
        self.convs1 = nn.ModuleList(
            [nn.Conv1d(ch, ch, kernel_size, dilation=d, padding=(kernel_size * d - d) // 2) for d in dilations]
        )
        self.convs2 = nn.ModuleList([nn.Conv1d(ch, ch, kernel_size, padding=(kernel_size - 1) // 2) for _ in dilations])


class SpeechT5HifiGan(nn.Module):
    def __init__(self, cfg: VocoderConfig = VocoderConfig()):
        super().__init__()
        self.cfg = cfg
        c0 = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.model_in_dim, c0, 7, padding=3)
        self.upsampler = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (rate, ksize) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch = c0 // (2 ** (i + 1))
            self.upsampler.append(nn.ConvTranspose1d(c0 // (2**i), ch, ksize, stride=rate, padding=(ksize - rate) // 2))
            for k, dil in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(HifiGanResidualBlock(ch, k, dil))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)
        self.register_buffer("mean", torch.zeros(cfg.model_in_dim))
        self.register_buffer("scale", torch.ones(cfg.model_in_dim))

    def stage_lengths(self, t: int) -> list[int]:
        """Output length of every upsample stage for ``t`` input frames."""
        lens = []
        for rate, ksize in zip(self.cfg.upsample_rates, self.cfg.upsample_kernel_sizes):
            t = (t - 1) * rate - 2 * ((ksize - rate) // 2) + ksize
            lens.append(t)
        return lens

    def route_from(self, t: int):
        """First stage index from which every stage goes through K2, or None."""
        cfg = self.cfg
        kp = self.conv_post.weight.shape[-1]
        if not mrf_conv.topology_ok(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes, kp):
            return None
        lens = self.stage_lengths(t)
        chans = [cfg.upsample_initial_channel // (2 ** (i + 1)) for i in range(len(lens))]
        for i in range(len(lens)):
            if all(mrf_conv.supported(lens[j], chans[j], torch.float32) for j in range(i, len(lens))):
                return i
        return None

    def forward(self, spectrogram: torch.Tensor) -> torch.Tensor:
        """``spectrogram`` [B, T, model_in_dim] -> waveform [B, T * hop] fp32."""
        cfg = self.cfg
        x = spectrogram.float()
        if cfg.normalize_before:
            x = (x - self.mean) / self.scale
        h = self.conv_pre(x.transpose(1, 2))
        nk = len(cfg.resblock_kernel_sizes)
        route = self.route_from(spectrogram.shape[1])
        for i, up in enumerate(self.upsampler):
            h = up(F.leaky_relu(h, cfg.leaky_relu_slope))
            blocks = list(self.resblocks[i * nk : (i + 1) * nk])
            if route is not None and i >= route:
                last = i == len(self.upsampler) - 1
                h = mrf_conv.mrf_stage(
                    h, blocks, cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes,
                    cfg.leaky_relu_slope, post=self.conv_post if last else None,
                )
                if last:
                    return h[:, 0]
            else:
                h = mrf_conv.mrf_stage_plain(h, blocks, cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes, cfg.leaky_relu_slope)
        h = torch.tanh(self.conv_post(F.leaky_relu(h, 0.01)))
        return h[:, 0]
