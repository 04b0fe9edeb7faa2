"""ctypes binding of the C++ WAV decoder, ``csrc/wavio.cpp``.

Counterpart of ``diffsep_tpu/data/native_io.py``: ``load_wav``,
``load_wav_batch`` (one call decodes a batch of files on a pool of C++
threads, without the interpreter lock), ``save_wav`` (16-bit PCM) and
``available``. The port keeps its own copy of the source and builds it at
first use with the host C++ compiler (``$CXX``, else ``c++``) into
``build/kernels/wavio-<hash>.so`` beside the package, the hash covering the
source and the flags, as ``ops/_build.py`` builds the CUDA kernels. A
failed build raises with the compiler's output. Decoded samples equal
scipy's bit for bit (integer PCM scaled by a power of two).

``batch_calls`` counts the ``load_wav_batch`` calls, so a run can show that
its loader took the native path.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from ..ops._build import BUILD_DIR, CSRC

log = logging.getLogger(__name__)

SOURCE = CSRC / "wavio.cpp"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

batch_calls = 0  # load_wav_batch calls in this process

_lib = None
_lock = threading.Lock()
_warned = False


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler found (set CXX): the WAV decoder cannot be built")
    return cxx


def _target() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + SOURCE.read_bytes())
    return BUILD_DIR / f"wavio-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """The decoder's library, compiled first if it is not built yet."""
    target = _target()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the WAV decoder failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, target)
    return target


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
                                     ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
            lib.wav_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
            lib.wav_read_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                           ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                                           ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int]
            lib.wav_write.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
                                      ctypes.c_int64, ctypes.c_int32]
            for fn in (lib.wav_info, lib.wav_read, lib.wav_read_batch, lib.wav_write):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the decoder builds and loads here. Where it does not, a
    warning says why, once per process."""
    global _warned
    try:
        _load()
        return True
    except (RuntimeError, OSError) as e:
        if not _warned:
            _warned = True
            log.warning("native WAV decoder unavailable, decoding file by file with scipy: %s", e)
        return False


def _info(lib, path) -> Tuple[int, int, int]:
    ch, nf, sr = ctypes.c_int32(), ctypes.c_int64(), ctypes.c_int32()
    rc = lib.wav_info(str(path).encode(), ctypes.byref(ch), ctypes.byref(nf), ctypes.byref(sr))
    if rc != 0:
        raise IOError(f"cannot parse wav header: {path} (rc={rc})")
    return ch.value, nf.value, sr.value


def _float_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_wav(path) -> Tuple[np.ndarray, int]:
    """(float32 (channels, frames) in [-1, 1], sample rate)."""
    lib = _load()
    ch, nf, sr = _info(lib, path)
    out = np.empty((ch, nf), np.float32)
    rc = lib.wav_read(str(path).encode(), _float_ptr(out), nf)
    if rc != 0:
        raise IOError(f"cannot decode wav data: {path} (rc={rc})")
    return out, sr


def load_wav_batch(paths: Sequence, n_threads: int | None = None) -> List[np.ndarray]:
    """Decode many files at once on ``n_threads`` threads (default: up to 8);
    a list of (channels, frames) float32 arrays in the order of ``paths``."""
    global batch_calls
    lib = _load()
    infos = [_info(lib, p) for p in paths]
    bufs = [np.empty((ch, nf), np.float32) for ch, nf, _ in infos]
    n = len(bufs)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    c_outs = (ctypes.POINTER(ctypes.c_float) * n)(*[_float_ptr(b) for b in bufs])
    c_lens = (ctypes.c_int64 * n)(*[nf for _, nf, _ in infos])
    failures = lib.wav_read_batch(c_paths, c_outs, c_lens, n, n_threads or min(8, os.cpu_count() or 1))
    if failures:
        raise IOError(f"{failures} of {n} files failed to decode")
    with _lock:
        batch_calls += 1
    return bufs


def save_wav(path, data: np.ndarray, fs: int) -> None:
    """Write (channels, frames) or (frames,) float data as 16-bit PCM."""
    lib = _load()
    data = np.ascontiguousarray(data, np.float32)
    if data.ndim == 1:
        data = data[None]
    rc = lib.wav_write(str(path).encode(), _float_ptr(data), data.shape[0], data.shape[1], fs)
    if rc != 0:
        raise IOError(f"cannot write wav: {path}")
