"""Proximity gauges between sampling paths' outputs (port of
audioldm_tpu/eval/proximity.py).

Proximity, not quality: the fast sampling paths (limited-interval guidance,
DPM-Solver++, LCM, MultiDiffusion windows) change the sampling math, and
their claims of preserved quality need real weights. What can be measured
with seeded random weights is how close each path's output stays to the
50-step DDIM output of the same seed: a tripwire for a change that wrecks a
fast path's output while its latency stays flat.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from audioldm_tpu_torch.ops.mel import hann_window, mel_filterbank


def log_mel_host(wav: np.ndarray, sr: int = 16000, n_fft: int = 1024, hop: int = 160, n_mels: int = 64) -> np.ndarray:
    """Host-side numpy log-mel ``[frames, n_mels]`` for the correlation
    gauge. Not the model's mel space: a power spectrum with ``n_fft // 2``
    reflect padding (librosa's convention), where ``ops/mel.py`` computes a
    magnitude STFT with ``(filter_length - hop) // 2`` padding. The gauge only
    correlates two outputs of this function. It shares the Slaney bank, the
    Hann window and the 1e-5 log floor with ``ops/mel.py``."""
    wav = np.asarray(wav, np.float64)
    y = np.pad(wav, (n_fft // 2, n_fft // 2), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = y[idx] * hann_window(n_fft).astype(np.float64)
    power = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    mel = power @ mel_filterbank(sr, n_fft, n_mels).astype(np.float64).T
    return np.log(np.clip(mel, 1e-5, None)).astype(np.float32)


def mel_correlation(wav_a: np.ndarray, wav_b: np.ndarray, sr: int = 16000) -> float:
    """Pearson correlation of the two waveforms' log-mels (flattened, cut to
    the common length). 1.0 is identical spectro-temporal content;
    uncorrelated random audio sits near 0."""
    n = min(len(wav_a), len(wav_b))
    a = log_mel_host(np.asarray(wav_a)[:n], sr=sr).ravel()
    b = log_mel_host(np.asarray(wav_b)[:n], sr=sr).ravel()
    a = a - a.mean()
    b = b - b.mean()
    denom = float(np.sqrt((a * a).sum() * (b * b).sum()))
    if denom < 1e-12:
        return 0.0
    return float((a * b).sum() / denom)


def embedding_cosine(a: np.ndarray, b: np.ndarray) -> float:
    """Plain cosine between two embedding vectors."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12))


@torch.no_grad()
def calibrate_vocoder_gain(modules, mel_shape, target: float = 0.3, iters: int = 4, probe: torch.Tensor | None = None) -> float:
    """Scale ``modules.vocoder.conv_post`` (the last layer, before tanh) in
    place so that a unit-normal mel probe ``[B, T, F]`` comes out at about
    ``target`` amplitude after tanh; returns the total scale applied.

    A random-weight vocoder defeats the proximity gauges both ways:
    amplitudes near 1e-4 ride the log-mel's 1e-5 floor (agreement on
    silence), and a large init rails tanh to +-1, so every input collapses
    onto one square wave and every correlation reads 1.0. The atanh
    inversion clamps at 0.999, so a railed vocoder converges over ``iters``
    passes. On failure the weights are restored and a ``RuntimeError`` is
    raised. ``probe`` defaults to a draw from a CPU generator seeded with 7."""
    post = modules.vocoder.conv_post
    saved = (post.weight.detach().clone(), post.bias.detach().clone())
    if probe is None:
        probe = torch.randn(tuple(mel_shape), generator=torch.Generator().manual_seed(7))
    probe = probe.to(device=post.weight.device, dtype=post.weight.dtype)

    def amplitude() -> float:
        return float(modules.vocoder(probe).abs().max())

    def fail(msg: str):
        post.weight.copy_(saved[0])
        post.bias.copy_(saved[1])
        raise RuntimeError(msg)

    total = 1.0
    for _ in range(iters):
        m = amplitude()
        if not math.isfinite(m) or m <= 1e-8:
            fail(f"vocoder probe amplitude {m!r} is unusable for gain calibration (dead or non-finite conv_post output)")
        scale = math.atanh(target) / max(math.atanh(min(m, 0.999)), 1e-12)
        if abs(scale - 1.0) < 0.05:
            return total
        post.weight.mul_(scale)
        post.bias.mul_(scale)
        total *= scale
    # the passes ran out before the scale settled: verify, a strongly railed
    # vocoder comes down only ~0.08x a pass and would leave still railed
    m = amplitude()
    if not 0.02 <= m <= 0.98:
        fail(f"vocoder gain calibration did not converge in {iters} passes (final probe amplitude {m:.3g}, target {target})")
    return total
