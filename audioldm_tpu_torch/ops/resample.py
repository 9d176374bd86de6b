"""Polyphase windowed-sinc resampler (port of audioldm_tpu/ops/resample.py):
``torchaudio.functional.resample`` with its defaults
(``lowpass_filter_width=6``, ``rolloff=0.99``, Hann-windowed sinc).

``resample`` runs on the device of its tensor, one strided convolution of
the polyphase bank; ``resample_np`` is the same on the host in numpy (the
input clip of audio-to-audio, and the data pipeline's fallback when the
native library cannot be built).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _sinc_resample_kernel(
    orig_freq: int, new_freq: int, lowpass_filter_width: int = 6, rolloff: float = 0.99
) -> tuple[np.ndarray, int, int, int]:
    """The polyphase kernel bank: ``(kernels [up, 2 * width + down] float32,
    width, up, down)``."""
    gcd = math.gcd(int(orig_freq), int(new_freq))
    down, up = int(orig_freq) // gcd, int(new_freq) // gcd
    base_freq = min(down, up) * rolloff
    width = int(math.ceil(lowpass_filter_width * down / base_freq))
    idx = np.arange(-width, width + down, dtype=np.float64)[None, :] / down
    t = np.arange(0, -up, -1, dtype=np.float64)[:, None] / up + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t *= np.pi
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    return (kernels * window * (base_freq / down)).astype(np.float32), width, up, down


def resample(
    waveform: torch.Tensor, orig_freq: int, new_freq: int, lowpass_filter_width: int = 6, rolloff: float = 0.99
) -> torch.Tensor:
    """Resample ``[..., T]`` from ``orig_freq`` to ``new_freq`` on the
    tensor's device: fp32 ``[..., ceil(new_freq * T / orig_freq)]``.

    One ``F.conv1d`` of the ``[up, 1, taps]`` bank with stride ``down`` over
    the input padded by ``width`` and ``width + down``, then the ``up``
    phases interleaved, as the JAX package computes it. The convolution runs
    in float64 (cuDNN's on the card), so no TF32 setting reaches it and its
    sums round once, at the cast back to fp32."""
    if orig_freq == new_freq:
        return waveform
    kernels, width, up, down = _sinc_resample_kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)
    shape = waveform.shape
    length = shape[-1]
    x = F.pad(waveform.reshape(-1, 1, length).double(), (width, width + down))
    bank = torch.as_tensor(kernels, device=waveform.device).double()[:, None, :]  # [up, 1, taps]
    y = F.conv1d(x, bank, stride=down)  # [B, up, frames]
    y = y.transpose(1, 2).reshape(x.shape[0], -1)  # phases interleaved
    target_length = int(math.ceil(new_freq * length / orig_freq))
    return y[:, :target_length].float().reshape(*shape[:-1], target_length)


def resample_np(
    waveform: np.ndarray, orig_freq: int, new_freq: int, lowpass_filter_width: int = 6, rolloff: float = 0.99
) -> np.ndarray:
    """Resample ``[..., T]`` from ``orig_freq`` to ``new_freq``: fp32
    ``[..., ceil(new_freq * T / orig_freq)]``."""
    if orig_freq == new_freq:
        return waveform
    kernels, width, up, down = _sinc_resample_kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)
    shape = waveform.shape
    length = shape[-1]
    x = np.pad(np.asarray(waveform, np.float32).reshape(-1, length), ((0, 0), (width, width + down)))
    # a strided correlation with every phase's kernel: frames [B, n, taps] x kernels [up, taps]
    frames = np.lib.stride_tricks.sliding_window_view(x, kernels.shape[1], axis=-1)[:, ::down]
    y = np.einsum("bnk,uk->bnu", frames, kernels).reshape(x.shape[0], -1)  # phases interleaved
    target_length = int(math.ceil(new_freq * length / orig_freq))
    return y[:, :target_length].reshape(shape[:-1] + (target_length,))
