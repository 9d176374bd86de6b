"""ctypes bindings of the native host-DSP library ``cpp/audioprep.cpp`` (the
port's own loader; the JAX package has its own).

The library is built at first use with ``g++`` into
``audioldm_tpu_torch/_build/libaudioprep.so`` (rebuilt when the source is
newer; nothing is written under ``cpp/``). Without a compiler, or without
the source, every function takes its numpy path (the same numbers up to
fp32 rounding): this is host code, the data pipeline's per-clip loops. The
polyphase kernel bank comes from ``ops.resample``, so the host and the
device resample with one filter.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import threading

import numpy as np

_LIB = None
_LOCK = threading.Lock()
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(os.path.dirname(_PKG), "cpp", "audioprep.cpp")
SO = os.path.join(_PKG, "_build", "libaudioprep.so")


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        try:
            if not os.path.exists(SO) or os.path.getmtime(SO) < os.path.getmtime(SRC):
                os.makedirs(os.path.dirname(SO), exist_ok=True)
                tmp = f"{SO}.{os.getpid()}.tmp"  # another process may build at the same time
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, SRC], check=True, capture_output=True)
                os.replace(tmp, SO)
            lib = ctypes.CDLL(SO)
            f32, i64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
            lib.resample_poly_f32.argtypes = [f32, i64, f32, i64, f32, i64, i64, i64, i64]
            lib.normalize_wav_f32.argtypes = [f32, i64, ctypes.c_float]
            lib.peak_abs_f32.argtypes = [f32, i64]
            lib.peak_abs_f32.restype = ctypes.c_float
            lib.decode_pcm16_f32.argtypes = [ctypes.POINTER(ctypes.c_int16), i64, ctypes.c_int32, f32]
            _LIB = lib
        except (OSError, subprocess.CalledProcessError):  # no g++ or no source, a failed build, a failed load
            _LIB = False
    return _LIB


def available() -> bool:
    """Whether the native library is built and loaded (else numpy paths)."""
    return bool(_load())


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resample_native(waveform: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Host polyphase resample of a 1-D clip, with ``ops.resample``'s bank
    (double accumulation); ``resample_np`` without the library."""
    from audioldm_tpu_torch.ops.resample import _sinc_resample_kernel, resample_np

    lib = _load()
    if not lib:
        return resample_np(waveform, orig_freq, new_freq)
    kernels, width, up, down = _sinc_resample_kernel(orig_freq, new_freq)
    k = np.ascontiguousarray(kernels, np.float32)  # [up, taps]
    x = np.ascontiguousarray(waveform, np.float32)
    n_out = int(math.ceil(new_freq * x.shape[-1] / orig_freq))
    out = np.empty(n_out, np.float32)
    lib.resample_poly_f32(_fptr(x), x.shape[-1], _fptr(out), n_out, _fptr(k), up, down, width, k.shape[1])
    return out


def normalize_native(waveform: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """``ops.mel.normalize_wav`` (mean-centre, peak to 0.5) on a copy."""
    lib = _load()
    x = np.ascontiguousarray(waveform, np.float32).copy()
    if not lib:
        from audioldm_tpu_torch.ops.mel import normalize_wav

        return normalize_wav(x, eps)
    lib.normalize_wav_f32(_fptr(x), x.shape[-1], eps)
    return x


def peak_abs(waveform: np.ndarray) -> float:
    lib = _load()
    x = np.ascontiguousarray(waveform, np.float32)
    if not lib:
        return float(np.max(np.abs(x))) if x.size else 0.0
    return float(lib.peak_abs_f32(_fptr(x), x.shape[-1]))


def decode_pcm16(data: bytes, channels: int) -> np.ndarray:
    """PCM16 bytes -> float32 mono in [-1, 1), channels averaged; a cut last
    frame is dropped. The numpy path gives the same bits."""
    raw = np.frombuffer(data, dtype="<i2")
    n_frames = raw.shape[0] // channels
    raw = raw[: n_frames * channels]
    lib = _load()
    if not lib:
        x = raw.astype(np.float32) / 32768.0
        return x.reshape(-1, channels).mean(axis=1) if channels > 1 else x
    raw = np.ascontiguousarray(raw)
    out = np.empty(n_frames, np.float32)
    lib.decode_pcm16_f32(raw.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n_frames, channels, _fptr(out))
    return out
