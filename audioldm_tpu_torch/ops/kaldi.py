"""Kaldi-compatible log mel filterbank features (the port's copy of
audioldm_tpu/ops/kaldi.py).

Re-implements the exact semantics of ``torchaudio.compliance.kaldi.fbank`` as
the reference invokes it (script/data/dataset_plugin.py:362-370,405-413):
``htk_compat=True, use_energy=False, window_type="hanning", num_mel_bins=128,
dither=0.0, frame_shift=10`` with torchaudio/Kaldi defaults for everything
else (frame_length 25 ms, snip_edges, remove_dc_offset, preemphasis 0.97,
round_to_power_of_two, use_power, low_freq 20, high_freq = nyquist).

The algorithm follows the published Kaldi/torchaudio definition (torchaudio
is not a dependency). Host-side numpy: it runs in the data pipeline's
plugins, off the device.
"""

from __future__ import annotations

import numpy as np

_EPSILON = float(np.finfo(np.float32).eps)  # torchaudio _get_epsilon


def _mel(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, np.float64) / 700.0)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def mel_banks(
    num_bins: int,
    padded_window_size: int,
    sample_freq: float,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """Kaldi triangular mel banks over fft bins ``[0, padded//2)`` —
    torchaudio ``get_mel_banks`` (vtln disabled); ``high_freq <= 0`` means
    nyquist + high_freq."""
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    fft_bin_width = sample_freq / padded_window_size
    mel_low = _mel(low_freq)
    mel_high = _mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_idx = np.arange(num_bins, dtype=np.float64)[:, None]
    left_mel = mel_low + bin_idx * mel_delta
    center_mel = mel_low + (bin_idx + 1.0) * mel_delta
    right_mel = mel_low + (bin_idx + 2.0) * mel_delta

    freqs = fft_bin_width * np.arange(padded_window_size // 2, dtype=np.float64)[None, :]
    mel_f = _mel(freqs)
    up = (mel_f - left_mel) / (center_mel - left_mel)
    down = (right_mel - mel_f) / (right_mel - center_mel)
    banks = np.maximum(0.0, np.minimum(up, down))
    return banks.astype(np.float32)  # [num_bins, padded//2]


def kaldi_fbank(
    waveform: np.ndarray,
    sample_frequency: float = 16000.0,
    num_mel_bins: int = 128,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    preemphasis_coefficient: float = 0.97,
    remove_dc_offset: bool = True,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
    use_power: bool = True,
) -> np.ndarray:
    """``waveform`` [samples] float -> log-mel fbank [num_frames, num_bins],
    matching ``torchaudio.compliance.kaldi.fbank(..., htk_compat=True,
    use_energy=False, window_type='hanning', dither=0.0)``."""
    wav = np.asarray(waveform, np.float32).reshape(-1)
    window_size = int(sample_frequency * frame_length_ms / 1000.0)
    window_shift = int(sample_frequency * frame_shift_ms / 1000.0)
    padded = _next_pow2(window_size)
    n = wav.shape[0]
    if n < window_size:
        return np.zeros((0, num_mel_bins), np.float32)
    m = 1 + (n - window_size) // window_shift  # snip_edges=True

    idx = np.arange(window_size)[None, :] + window_shift * np.arange(m)[:, None]
    frames = wav[idx].astype(np.float32)  # [m, window_size]

    if remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if preemphasis_coefficient != 0.0:
        # replicate-pad on the left: frame[0] -= c * frame[0]
        prev = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - preemphasis_coefficient * prev

    # Kaldi "hanning" = symmetric hann (torch.hann_window(periodic=False))
    win = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(window_size) / (window_size - 1))).astype(np.float32)
    frames = frames * win

    if padded > window_size:
        frames = np.pad(frames, ((0, 0), (0, padded - window_size)))

    spectrum = np.abs(np.fft.rfft(frames, axis=1)).astype(np.float32)  # [m, padded//2+1]
    if use_power:
        spectrum = spectrum**2

    banks = mel_banks(num_mel_bins, padded, float(sample_frequency), low_freq, high_freq)
    banks = np.pad(banks, ((0, 0), (0, 1)))  # zero nyquist column (torchaudio)
    mel_energies = spectrum @ banks.T  # [m, num_bins]
    return np.log(np.maximum(mel_energies, _EPSILON)).astype(np.float32)
