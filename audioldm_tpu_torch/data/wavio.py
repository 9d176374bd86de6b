"""WAV input and output without audio libraries (the port's own copies of
the JAX package's ``read_wav`` and ``write_wav``): a small RIFF reader for
PCM 8/16/24/32 and float 32/64, and a 16-bit PCM writer."""

from __future__ import annotations

import struct
import wave

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a wav file: ``(float32 mono waveform in [-1, 1], sample_rate)``;
    channels are averaged."""
    with open(path, "rb") as f:
        header = f.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        fmt = data = None
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                break
            cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
            payload = f.read(size + (size % 2))[:size]
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
                if fmt[0] == 0xFFFE and len(payload) >= 26:
                    # WAVE_FORMAT_EXTENSIBLE: the format code is the first
                    # two bytes of the SubFormat GUID (offset 24)
                    fmt = (struct.unpack("<H", payload[24:26])[0],) + fmt[1:]
            elif cid == b"data":
                data = payload
    if fmt is None or data is None:
        raise ValueError(f"missing fmt/data chunk: {path}")
    audio_format, channels, sr, _, _, bits = fmt
    if audio_format == 3:
        x = np.frombuffer(data, dtype="<f8" if bits == 64 else "<f4").astype(np.float32)
    elif audio_format != 1:
        # integer PCM only below: a mu-law or a-law file also reports 8 bits
        raise ValueError(f"unsupported wav: format={audio_format} bits={bits}")
    elif bits == 16:  # decoded and downmixed in one pass by the native library (numpy without it)
        from audioldm_tpu_torch.data import native

        x, channels = native.decode_pcm16(data, channels), 1
    elif bits == 32:
        x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    elif bits == 24:
        raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
        x = raw[:, 0] | (raw[:, 1] << 8) | (raw[:, 2] << 16)
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
    elif bits == 8:
        x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported wav: format={audio_format} bits={bits}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, sr


def write_wav(path: str, waveform: np.ndarray, sample_rate: int = 16000):
    """Write a float waveform in [-1, 1] as 16-bit PCM mono."""
    x = np.clip(np.asarray(waveform, np.float32), -1.0, 1.0)
    pcm = np.round(x * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
