"""WAV output without audio libraries (the port's own copy of the JAX
package's ``write_wav``)."""

from __future__ import annotations

import wave

import numpy as np


def write_wav(path: str, waveform: np.ndarray, sample_rate: int = 16000):
    """Write a float waveform in [-1, 1] as 16-bit PCM mono."""
    x = np.clip(np.asarray(waveform, np.float32), -1.0, 1.0)
    pcm = np.round(x * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
