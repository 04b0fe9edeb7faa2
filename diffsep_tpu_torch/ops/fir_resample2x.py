"""Factor-2 FIR resampling of NHWC tensors with a separable 4-tap filter.

Counterpart of ``diffsep_tpu/ops/pallas/upfirdn.py`` (``_down_kernel``,
``_up_kernel``). ``fir_down2x``/``fir_up2x`` launch the hand-written CUDA
kernel ``csrc/fir_resample2x.cu`` for a CUDA tensor and take the plain
versions, the general ``upfirdn2d``, for a CPU tensor.

``taps`` are the 4 taps f of one axis, gain included; the 2-D filter is
outer(f, f):
  * fir_down2x == upfirdn2d(x, outer(f, f), down=2, pad=(1, 1))
  * fir_up2x   == upfirdn2d(x, outer(f, f), up=2, pad=(2, 1))
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from . import _build
from .upfirdn2d import out_size, upfirdn2d

Tensor = torch.Tensor

__all__ = ["fir_down2x", "fir_up2x", "fir_down2x_plain", "fir_up2x_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PADS = {False: (1, 1), True: (2, 1)}
_ARGTYPES = (
    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_float] * 8
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]
)


def _kernel2d(taps: Sequence[float]) -> np.ndarray:
    f = np.asarray(taps, np.float32)
    return np.outer(f, f)


def fir_down2x_plain(x: Tensor, taps: Sequence[float]) -> Tensor:
    return upfirdn2d(x, _kernel2d(taps), down=2, pad=_PADS[False], data_format="NHWC")


def fir_up2x_plain(x: Tensor, taps: Sequence[float]) -> Tensor:
    return upfirdn2d(x, _kernel2d(taps), up=2, pad=_PADS[True], data_format="NHWC")


def _launch(x: Tensor, taps: Sequence[float], up: bool) -> Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"fir_resample2x: no kernel for device {x.device}")
    if x.ndim != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(
            f"fir_resample2x: needs a contiguous float32/bfloat16 NHWC tensor, "
            f"got {tuple(x.shape)} {x.dtype}"
        )
    if len(taps) != 4:
        raise ValueError(f"fir_resample2x: needs 4 taps, got {len(taps)}")
    b, h, w, c = x.shape
    pad0, pad1 = _PADS[up]
    factor_up, factor_down = (2, 1) if up else (1, 2)
    ho = out_size(h, factor_up, factor_down, pad0, pad1, 4)
    wo = out_size(w, factor_up, factor_down, pad0, pad1, 4)
    out = torch.empty((b, ho, wo, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    kf = [float(t) for t in taps[::-1]]  # convolution = correlation with flipped taps
    fn = _build.entry("fir_resample2x", "fir_resample2x_nhwc", _ARGTYPES)
    err = fn(
        x.data_ptr(), out.data_ptr(), b, h, w, c, ho, wo, int(up), *kf, *kf,
        _DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    name = "fir_up2x" if up else "fir_down2x"
    _build.check(err, name)
    _build.count_launch(name, x.shape)
    return out


def fir_down2x(x: Tensor, taps: Sequence[float]) -> Tensor:
    """Factor-2 decimation of x (B, H, W, C) -> (B, H // 2, W // 2, C)."""
    if x.device.type == "cpu":
        return fir_down2x_plain(x, taps)
    return _launch(x, taps, up=False)


def fir_up2x(x: Tensor, taps: Sequence[float]) -> Tensor:
    """Factor-2 interpolation of x (B, H, W, C) -> (B, 2 H, 2 W, C)."""
    if x.device.type == "cpu":
        return fir_up2x_plain(x, taps)
    return _launch(x, taps, up=True)
