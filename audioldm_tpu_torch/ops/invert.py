"""Inverse DSP: iSTFT, Griffin-Lim phase recovery, mel inversion (port of
audioldm_tpu/ops/invert.py).

- ``window_sumsquare``: the librosa-0.6 sum-square Hann envelope;
- ``stft_complex`` / ``istft``: the complex STFT (center, reflect padding)
  and its inverse, windowed overlap-add divided by the envelope;
- ``griffin_lim``: iterative phase recovery from a magnitude STFT;
- ``inv_mel_spec``: log-mel -> linear magnitude through the mel basis's
  pseudo-inverse -> Griffin-Lim -> waveform.

Tensors stay on the device they come on; the Griffin-Lim phase init comes
from an explicit ``torch.Generator`` (or is given). No kernel of the JAX
package is involved: ``torch.stft`` and ``torch.fft`` carry the transforms.
Spectra are ``[..., frames, bins]``, as in the JAX package.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from audioldm_tpu_torch.ops.mel import hann_window, mel_filterbank


@functools.lru_cache(maxsize=None)
def window_sumsquare(n_frames: int, hop_length: int, win_length: int, n_fft: int) -> np.ndarray:
    """Sum-square Hann envelope over the overlap-add grid."""
    n = n_fft + hop_length * (n_frames - 1)
    x = np.zeros(n, np.float64)
    win_sq = hann_window(win_length).astype(np.float64) ** 2
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        win_sq = np.pad(win_sq, (pad, n_fft - win_length - pad))
    for i in range(n_frames):
        s = i * hop_length
        x[s : min(n, s + n_fft)] += win_sq[: max(0, min(n_fft, n - s))]
    return x.astype(np.float32)


def stft_complex(y: torch.Tensor, n_fft: int = 1024, hop_length: int = 160, win_length: int = 1024) -> torch.Tensor:
    """Complex STFT (center=True, reflect padding) of ``[..., samples]`` ->
    ``[..., frames, bins]``."""
    lead = y.shape[:-1]
    window = torch.from_numpy(hann_window(win_length)).to(y.device)
    spec = torch.stft(y.reshape(-1, y.shape[-1]).float(), n_fft, hop_length, win_length, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    return spec.transpose(-1, -2).reshape(*lead, spec.shape[-1], spec.shape[-2])


def istft(spec: torch.Tensor, n_fft: int = 1024, hop_length: int = 160, win_length: int = 1024,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse of ``stft_complex`` (center=True): windowed overlap-add of the
    inverse rFFT frames, divided by the sum-square envelope where it is
    above 1e-10. ``spec``: complex ``[..., frames, bins]``."""
    n_frames = spec.shape[-2]
    window = torch.from_numpy(hann_window(win_length)).to(spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    total = n_fft + hop_length * (n_frames - 1)
    lead = frames.shape[:-2]
    flat = frames.reshape(-1, n_frames, n_fft).transpose(1, 2)  # [B, n_fft, frames]: fold's column layout
    out = F.fold(flat, output_size=(1, total), kernel_size=(1, n_fft), stride=(1, hop_length))[:, 0, 0]
    wss = window_sumsquare(n_frames, hop_length, win_length, n_fft)
    out = out / torch.from_numpy(np.where(wss > 1e-10, wss, 1.0).astype(np.float32)).to(out.device)
    pad = n_fft // 2
    out = out[:, pad : total - pad]
    if length is not None:
        out = out[:, :length]
    return out.reshape(*lead, out.shape[-1])


def griffin_lim(
    magnitude: torch.Tensor, generator: Optional[torch.Generator] = None, n_iters: int = 30, n_fft: int = 1024,
    hop_length: int = 160, win_length: int = 1024, length: Optional[int] = None,
    phase: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Phase recovery from a magnitude STFT ``[..., frames, bins]``. The
    initial phase is ``phase`` when given, else uniform in ``[-pi, pi)``
    from ``generator`` (on the generator's device, then moved)."""
    if phase is None:
        gdev = generator.device if generator is not None else magnitude.device
        phase = torch.rand(magnitude.shape, generator=generator, device=gdev) * (2 * math.pi) - math.pi
    spec = magnitude * torch.exp(1j * phase.to(magnitude.device, torch.float32))
    for _ in range(n_iters):
        signal = istft(spec, n_fft, hop_length, win_length)
        new = stft_complex(signal, n_fft, hop_length, win_length)[..., : magnitude.shape[-2], :]
        spec = magnitude * (new / torch.clamp(new.abs(), min=1e-16))
    return istft(spec, n_fft, hop_length, win_length, length=length)


def inv_mel_spec(
    log_mel: torch.Tensor, generator: Optional[torch.Generator] = None, sampling_rate: int = 16000,
    n_fft: int = 1024, hop_length: int = 160, win_length: int = 1024, n_mel: int = 64, mel_fmin: float = 0.0,
    mel_fmax: float = 8000.0, n_iters: int = 32, phase: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Log-mel ``[..., frames, n_mel]`` -> waveform, through the mel basis's
    pseudo-inverse and Griffin-Lim (``phase``/``generator`` as there)."""
    basis = mel_filterbank(sampling_rate, n_fft, n_mel, mel_fmin, mel_fmax)  # [mel, bins]
    pinv = torch.from_numpy(np.linalg.pinv(basis).astype(np.float32)).to(log_mel.device)  # [bins, mel]
    mag = torch.clamp(torch.exp(log_mel.float()) @ pinv.T, min=0.0)
    return griffin_lim(mag, generator, n_iters, n_fft, hop_length, win_length, phase=phase)
