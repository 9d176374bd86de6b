"""CLAP's 48 kHz fused log-mel features (the port's copy of
audioldm_tpu/eval/clap_features.py).

``transformers.ClapFeatureExtractor`` as the reference's eval path drives it
(``clap_processor(audios=..., sampling_rate=48000)``): a power STFT (centred,
reflect pad, periodic Hann window, n_fft 1024, hop 480), the HTK-scale
unnormalised mel bank (0-14 kHz, 64 bins), ``power_to_db``, then the fusion
packing: a clip of at most 10 s is repeat-padded and stacked 4 times
(``is_longer`` False); a longer clip gives 3 random crops and a bilinear
overview of its whole mel (``is_longer`` True).

All on the host in numpy (the STFT in float64), as the JAX package computes
it; ``batch_fused_features`` hands the batch to the tower's device.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from audioldm_tpu_torch.ops.mel import hann_window, mel_filterbank

SR = 48000
N_FFT = 1024
HOP = 480
N_MELS = 64
FMIN, FMAX = 0.0, 14000.0
MAX_SAMPLES = 10 * SR  # 480000
CHUNK_FRAMES = MAX_SAMPLES // HOP + 1  # 1001


@functools.lru_cache(maxsize=1)
def _mel_bank_htk() -> np.ndarray:
    return mel_filterbank(SR, N_FFT, N_MELS, FMIN, FMAX, mel_scale="htk", norm=None)


def power_to_db(x: np.ndarray, min_value: float = 1e-10) -> np.ndarray:
    return 10.0 * np.log10(np.clip(x, min_value, None))


def clap_log_mel(waveform: np.ndarray) -> np.ndarray:
    """``[T]`` float -> ``[frames, 64]`` dB log-mel (``torch.stft`` with
    ``center=True``)."""
    pad = N_FFT // 2
    y = np.pad(waveform.astype(np.float64), (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - N_FFT) // HOP
    idx = np.arange(n_frames)[:, None] * HOP + np.arange(N_FFT)[None, :]
    frames = y[idx] * hann_window(N_FFT).astype(np.float64)
    power = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    mel = power @ _mel_bank_htk().astype(np.float64).T
    return power_to_db(mel).astype(np.float32)


def _linear_interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """The 1-D bilinear resize (``align_corners=False``) as a matrix
    ``[n_out, n_in]``."""
    w = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        src = (i + 0.5) * n_in / n_out - 0.5
        f = int(np.floor(src))
        t = src - f
        w[i, min(max(f, 0), n_in - 1)] += 1 - t
        w[i, min(max(f + 1, 0), n_in - 1)] += t
    return w.astype(np.float32)


def extract_fused_features(waveform: np.ndarray, rng: Optional[np.random.Generator] = None) -> tuple[np.ndarray, bool]:
    """One 48 kHz waveform -> ``(input_features [4, 1001, 64], is_longer)``.
    The crops of a clip over 10 s draw from ``rng`` (default
    ``default_rng(0)``), one ``choice`` each from the front, middle and back
    thirds of the start positions, as the JAX package draws them."""
    rng = rng or np.random.default_rng(0)
    n = waveform.shape[0]
    if n > MAX_SAMPLES:
        mel = clap_log_mel(waveform)
        total = mel.shape[0]
        if total == CHUNK_FRAMES:
            return np.stack([mel] * 4), False
        ranges = np.array_split(np.arange(0, total - CHUNK_FRAMES + 1), 3)
        idxs = [int(rng.choice(r)) if len(r) else 0 for r in ranges]
        crops = [mel[i : i + CHUNK_FRAMES] for i in idxs]
        shrink = _linear_interp_matrix(total, CHUNK_FRAMES) @ mel
        return np.stack([shrink] + crops).astype(np.float32), True
    if n < MAX_SAMPLES:  # repeat-pad: whole copies, then zeros
        waveform = np.tile(waveform, int(MAX_SAMPLES / n))
        waveform = np.pad(waveform, (0, MAX_SAMPLES - waveform.shape[0]))
    mel = clap_log_mel(waveform)
    return np.stack([mel] * 4), False


def batch_fused_features(
    waveforms: list[np.ndarray], rng: Optional[np.random.Generator] = None, device="cpu"
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(input_features [N, 4, 1001, 64] fp32, is_longer [N] bool)`` on
    ``device``, as the reference's eval path makes them:
    ``ClapFeatureExtractor`` (truncation "fusion") forces one sample of each
    batch to ``is_longer=True`` even when no clip is over 10 s, and the
    reference calls it once per clip, so every clip it scores goes through
    the fusion path (the JAX package's ``per_clip_batches=True``, the only
    form its callers use)."""
    feats = [extract_fused_features(np.asarray(w, np.float32), rng)[0] for w in waveforms]
    return torch.from_numpy(np.stack(feats)).to(device), torch.ones(len(feats), dtype=torch.bool, device=device)
