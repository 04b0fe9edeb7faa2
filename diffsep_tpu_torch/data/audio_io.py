"""WAV reading and writing on scipy.

Counterpart of ``load_wav``/``save_wav`` in ``diffsep_tpu/data/audio_io.py``:
float32 (channels, samples) in [-1, 1], integer PCM normalized as
torchaudio.load does.
"""
from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
from scipy.io import wavfile

__all__ = ["load_wav", "save_wav"]


def load_wav(path) -> Tuple[np.ndarray, int]:
    """Read a wav file -> (float32 (channels, samples) in [-1, 1], fs)."""
    fs, data = wavfile.read(str(path))
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


def save_wav(path, data: np.ndarray, fs: int, dtype: str = "int16") -> None:
    """Write (channels, samples) float data, as 16-bit PCM by default."""
    data = np.asarray(data)
    if data.ndim == 2:
        data = data.T if data.shape[0] > 1 else data[0]
    if dtype == "int16":
        data = (np.clip(data, -1.0, 1.0) * 32767.0).astype(np.int16)
    else:
        data = data.astype(np.float32)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    wavfile.write(str(path), fs, data)
