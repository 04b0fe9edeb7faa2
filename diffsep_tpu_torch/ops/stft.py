"""STFT / iSTFT with torch.stft semantics (onesided, unnormalized,
constant-padded centering).

Counterpart of ``diffsep_tpu/ops/stft.py``. The DFT is a matrix product
against a (n_fft, n_bins) basis, as in the JAX package: n_fft = 510 is not a
power of two, and the product keeps the two packages' arithmetic alike.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

__all__ = ["hann_window", "stft", "istft"]


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (``torch.hann_window(periodic=True)``)."""
    n = np.arange(win_length)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_basis(n_fft: int):
    """(n_fft, n_bins) cos and -sin matrices of the onesided DFT."""
    n = np.arange(n_fft)[:, None]
    f = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * f * n / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _idft_basis(n_fft: int):
    """(n_bins, n_fft) matrices for the real and imaginary parts of the
    inverse onesided DFT (interior bins counted twice)."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft)[None, :]
    f = np.arange(n_bins)[:, None]
    ang = 2.0 * np.pi * f * n / n_fft
    c = np.full((n_bins, 1), 2.0)
    c[0] = 1.0
    if n_fft % 2 == 0:
        c[-1] = 1.0
    return (
        (c * np.cos(ang) / n_fft).astype(np.float32),
        (-c * np.sin(ang) / n_fft).astype(np.float32),
    )


@functools.lru_cache(maxsize=None)
def _device_const(kind: str, n_fft: int, device: torch.device) -> Tensor:
    """The window or a DFT basis as a float32 tensor on `device`, made once:
    a copy from host memory per call would stall the host on the device."""
    mats = {"window": hann_window(n_fft)}
    mats["cos"], mats["msin"] = _dft_basis(n_fft)
    mats["re"], mats["im"] = _idft_basis(n_fft)
    return torch.from_numpy(mats[kind]).to(device)


def _const(kind: str, n_fft: int, like: Tensor) -> Tensor:
    return _device_const(kind, n_fft, like.device).to(like.dtype)


def _overlap_add(frames: Tensor, hop: int, out_len: int) -> Tensor:
    """y[..., k*hop + n] += frames[..., k, n], cut or zero-padded to out_len."""
    *batch, n_frames, n_fft = frames.shape
    n_chunks = -(-n_fft // hop)
    frames = F.pad(frames, (0, n_chunks * hop - n_fft))
    chunks = frames.reshape(*batch, n_frames, n_chunks, hop)
    y = frames.new_zeros((*batch, n_frames - 1 + n_chunks, hop))
    for j in range(n_chunks):
        y[..., j : j + n_frames, :] += chunks[..., :, j, :]
    y = y.reshape(*batch, -1)
    if y.shape[-1] < out_len:
        y = F.pad(y, (0, out_len - y.shape[-1]))
    return y[..., :out_len]


def stft(
    x: Tensor, n_fft: int = 510, hop_length: int = 128,
    window: Optional[Tensor] = None, center: bool = True,
) -> Tensor:
    """Complex STFT of a real signal (..., time) -> (..., n_bins, n_frames)."""
    if window is None:
        window = _const("window", n_fft, x)
    if center:
        p = n_fft // 2
        x = F.pad(x, (p, p))
    frames = x.unfold(-1, n_fft, hop_length) * window  # (..., K, n_fft)
    spec = torch.complex(frames @ _const("cos", n_fft, frames), frames @ _const("msin", n_fft, frames))
    return spec.transpose(-1, -2)


def istft(
    spec: Tensor, n_fft: int = 510, hop_length: int = 128,
    window: Optional[Tensor] = None, center: bool = True,
    length: Optional[int] = None, eps: float = 1e-11,
) -> Tensor:
    """Inverse STFT normalized by the overlap-added squared window."""
    re = spec.real.transpose(-1, -2)  # (..., K, n_bins)
    im = spec.imag.transpose(-1, -2)
    if window is None:
        window = _const("window", n_fft, re)
    n_frames = re.shape[-2]
    frames = (re @ _const("re", n_fft, re) + im @ _const("im", n_fft, re)) * window

    total = (n_frames - 1) * hop_length + n_fft
    y = _overlap_add(frames, hop_length, total)
    env = _overlap_add((window * window).expand(n_frames, n_fft), hop_length, total)
    y = y / torch.clamp(env, min=eps)

    if center:
        p = n_fft // 2
        y = y[..., p : total - p]
    if length is not None:
        if y.shape[-1] < length:
            y = F.pad(y, (0, length - y.shape[-1]))
        else:
            y = y[..., :length]
    elif center:
        y = y[..., : (n_frames - 1) * hop_length]
    return y
