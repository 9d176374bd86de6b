"""STFT, Slaney mel filterbank and log compression (port of
audioldm_tpu/ops/mel.py): the reference's training front end, which
audio-to-audio feeds the VAE with.

Reflect-pad by ``(filter_length - hop_length) / 2`` a side, framed real FFT
with a periodic Hann window, magnitude, mel projection, ``log(clamp(x,
1e-5))``. The tensor functions run on the device of their input; the mel
basis and the window are built on the host in float64 numpy. The FFT is
``torch.fft.rfft`` (the JAX package computes it with XLA's FFT, outside any
kernel of its own).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from audioldm_tpu_torch.config import MelConfig


def _hz_to_mel_slaney(frequencies: np.ndarray) -> np.ndarray:
    frequencies = np.asarray(frequencies, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    safe = np.maximum(frequencies, 1e-12)
    return np.where(frequencies >= min_log_hz, min_log_mel + np.log(safe / min_log_hz) / logstep, frequencies / f_sp)


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), f_sp * mels)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    sampling_rate: int = 16000, n_fft: int = 1024, n_mels: int = 64, fmin: float = 0.0, fmax: float = 8000.0,
    mel_scale: str = "slaney", norm: str | None = "slaney",
) -> np.ndarray:
    """Triangular mel filterbank, float32 ``[n_mels, n_fft // 2 + 1]``
    (librosa's layout): ``librosa.filters.mel`` with its defaults
    (``mel_scale="slaney"``, ``norm="slaney"``), or the HTK scale and no
    norm. The cached array is shared: do not write to it."""
    fftfreqs = np.linspace(0.0, sampling_rate / 2.0, 1 + n_fft // 2, dtype=np.float64)
    to_mel = _hz_to_mel_htk if mel_scale == "htk" else _hz_to_mel_slaney
    to_hz = _mel_to_hz_htk if mel_scale == "htk" else _mel_to_hz_slaney
    mel_f = to_hz(np.linspace(to_mel(np.array(fmin)), to_mel(np.array(fmax)), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    weights = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    if norm == "slaney":  # equal-area triangles
        weights = weights * (2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def hann_window(win_length: int = 1024) -> np.ndarray:
    """Periodic Hann window, ``torch.hann_window(win_length)`` in float32.
    The cached array is shared: do not write to it."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def stft_magnitude(
    y: torch.Tensor, n_fft: int = 1024, hop_length: int = 160, win_length: int = 1024,
    window: np.ndarray | None = None, center: bool = False,
) -> torch.Tensor:
    """Magnitude STFT of ``[..., T]`` (already padded by the caller when
    ``center=False``): ``[..., n_frames, n_fft // 2 + 1]``, time-major, as
    ``torch.stft(center=False, onesided=True, normalized=False)`` computes it
    up to the transpose."""
    if window is None:
        window = hann_window(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    y = y.float()
    if center:
        lead = y.shape[:-1]
        y = F.pad(y.reshape(-1, 1, y.shape[-1]), (n_fft // 2, n_fft // 2), mode="reflect").reshape(*lead, -1)
    frames = y.unfold(-1, n_fft, hop_length) * torch.as_tensor(window, device=y.device)
    return torch.fft.rfft(frames, dim=-1).abs()


def dynamic_range_compression(x: torch.Tensor, C: float = 1.0, clip_val: float = 1e-5) -> torch.Tensor:
    """``log(clamp(x, min=clip_val) * C)``."""
    return torch.log(x.clamp_min(clip_val) * C)


def pad_spec(spec: torch.Tensor, target_length: int) -> torch.Tensor:
    """Pad or crop the time axis of ``[..., n_frames, n_bins]`` to
    ``target_length`` frames and drop an odd last frequency bin."""
    n_frames = spec.shape[-2]
    if n_frames < target_length:
        spec = F.pad(spec, (0, 0, 0, target_length - n_frames))
    elif n_frames > target_length:
        spec = spec[..., :target_length, :]
    if spec.shape[-1] % 2 != 0:
        spec = spec[..., :-1]
    return spec


def log_mel_spectrogram(wav: torch.Tensor, cfg: MelConfig = MelConfig(), return_stft: bool = False):
    """The reference's feature path: ``wav`` ``[..., num_samples]`` fp32 in
    [-1, 1] -> log-mel ``[..., target_length, n_mel]`` (and with
    ``return_stft`` the ``[..., target_length, n_fft // 2]`` magnitude STFT)."""
    pad = int((cfg.filter_length - cfg.hop_length) / 2)
    lead = wav.shape[:-1]
    y = F.pad(wav.float().reshape(-1, 1, wav.shape[-1]), (pad, pad), mode="reflect").reshape(*lead, -1)
    mag = stft_magnitude(y, n_fft=cfg.filter_length, hop_length=cfg.hop_length, win_length=cfg.win_length, center=False)
    basis = torch.as_tensor(
        mel_filterbank(cfg.sampling_rate, cfg.filter_length, cfg.n_mel, cfg.mel_fmin, cfg.mel_fmax), device=wav.device
    )
    log_mel = pad_spec(dynamic_range_compression(torch.matmul(mag, basis.T)), cfg.target_length)
    if return_stft:
        return log_mel, pad_spec(mag, cfg.target_length)
    return log_mel


def normalize_wav(waveform: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Mean-centre, peak-normalise, scale to a largest amplitude of 0.5
    (host-side numpy, as the reference's data path does)."""
    waveform = waveform - np.mean(waveform)
    waveform = waveform / (np.max(np.abs(waveform)) + eps)
    return (waveform * 0.5).astype(np.float32)


def pad_wav(waveform: np.ndarray, target_length: int) -> np.ndarray:
    """Zero-pad or crop to exactly ``target_length`` samples, content at the start."""
    length = waveform.shape[-1]
    if length == target_length:
        return waveform
    if length > target_length:
        return waveform[..., :target_length]
    out = np.zeros(waveform.shape[:-1] + (target_length,), dtype=np.float32)
    out[..., :length] = waveform
    return out
