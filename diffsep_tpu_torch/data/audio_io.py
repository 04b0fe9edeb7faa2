"""WAV reading and writing on scipy, from files or bytes in memory.

Counterpart of ``diffsep_tpu/data/audio_io.py``: float32 (channels,
samples) in [-1, 1], integer PCM normalized as torchaudio.load does. The
in-memory pair serves the HTTP front end (request and response bodies).
``set_backend("native")`` makes ``load_wav`` decode with the C++ decoder
of ``native_io.py`` instead of scipy.
"""
from __future__ import annotations

import io
from pathlib import Path
from typing import Tuple

import numpy as np
from scipy.io import wavfile

__all__ = ["load_wav", "load_wav_bytes", "save_wav", "set_backend", "wav_to_bytes"]

_BACKENDS = ("scipy", "native")
_backend = "scipy"


def set_backend(name: str) -> None:
    """The decoder of ``load_wav``: "scipy" (the default) or "native"."""
    global _backend
    if name not in _BACKENDS:
        raise ValueError(f"unknown wav backend {name!r}; one of {_BACKENDS}")
    _backend = name


def _normalize_decoded(fs: int, data: np.ndarray) -> Tuple[np.ndarray, int]:
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    data = data[None, :] if data.ndim == 1 else data.T
    return np.ascontiguousarray(data), int(fs)


def _encode_pcm(data: np.ndarray, dtype: str) -> np.ndarray:
    """(channels, samples) float -> what scipy writes: (samples, channels),
    or (samples,) for one channel; 16-bit PCM by default."""
    data = np.asarray(data)
    if data.ndim == 2:
        data = data.T if data.shape[0] > 1 else data[0]
    if dtype == "int16":
        return (np.clip(data, -1.0, 1.0) * 32767.0).astype(np.int16)
    return data.astype(np.float32)


def load_wav(path) -> Tuple[np.ndarray, int]:
    """Read a wav file -> (float32 (channels, samples) in [-1, 1], fs)."""
    if _backend == "native":
        from . import native_io

        return native_io.load_wav(path)
    return _normalize_decoded(*wavfile.read(str(path)))


def load_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode wav bytes (an HTTP request body) -> (float32 (channels,
    samples) in [-1, 1], fs)."""
    return _normalize_decoded(*wavfile.read(io.BytesIO(data)))


def save_wav(path, data: np.ndarray, fs: int, dtype: str = "int16") -> None:
    """Write (channels, samples) float data, as 16-bit PCM by default."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    wavfile.write(str(path), fs, _encode_pcm(data, dtype))


def wav_to_bytes(data: np.ndarray, fs: int, dtype: str = "int16") -> bytes:
    """Encode (channels, samples) float data as wav bytes: separated sources
    become one multi-channel wav, channel i = source i."""
    buf = io.BytesIO()
    wavfile.write(buf, fs, _encode_pcm(data, dtype))
    return buf.getvalue()
