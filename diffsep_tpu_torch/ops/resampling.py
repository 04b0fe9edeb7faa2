"""FIR up/down-sampling wrappers (StyleGAN2 style).

Counterpart of ``upsample_2d``/``downsample_2d``/``setup_kernel`` in
``diffsep_tpu/ops/resampling.py``. A factor-2 call with a separable 4-tap
filter on NHWC data, which is every call NCSN++ makes, goes to the FIR 2x
kernel (``fir_resample2x``) with the 1-D taps normalized per axis. Any other
call (another factor, a 2-D or longer filter, NCHW data) runs the plain
``upfirdn2d`` on the 2-D ``setup_kernel``, on the CPU or the card alike, as
the JAX package computes such calls outside its TPU kernel
(``upfirdn2d_ref``, an XLA convolution).

``upsample_conv_2d`` and ``conv_downsample_2d`` are the fused resample
convs of the ``with_conv`` resamplers (NCHW data, OIHW weight): the
strided and transposed convs are the framework's (cuDNN on the card), as
they are XLA convs outside any TPU kernel in the JAX package, and their
FIR tails, whose pads no kernel serves, run the plain ``upfirdn2d``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import fir_resample2x
from .upfirdn2d import upfirdn2d

Tensor = torch.Tensor

__all__ = ["setup_kernel", "upsample_2d", "downsample_2d", "upsample_conv_2d", "conv_downsample_2d",
           "naive_upsample_2d", "naive_downsample_2d"]


def setup_kernel(k) -> np.ndarray:
    """Normalize a 1-D (separable) or 2-D FIR kernel to unit DC gain."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k = k / k.sum()
    assert k.ndim == 2 and k.shape[0] == k.shape[1]
    return k


def _resample(x: Tensor, k, factor: int, gain: float, up: bool, data_format: str) -> Tensor:
    k = [1.0] * factor if k is None else k
    if factor == 2 and data_format == "NHWC" and np.ndim(k) == 1 and len(k) == 4:
        # separable: outer(f, f) == setup_kernel(k) * gain * (4 if up else 1)
        f = np.asarray(k, np.float64)
        f = f / f.sum() * np.sqrt(gain) * (factor if up else 1)
        taps = tuple(float(v) for v in f)
        return (fir_resample2x.fir_up2x if up else fir_resample2x.fir_down2x)(x, taps)
    k = setup_kernel(k) * (gain * factor**2 if up else gain)
    p = k.shape[0] - factor
    if up:
        return upfirdn2d(
            x, k, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2),
            data_format=data_format,
        )
    return upfirdn2d(x, k, down=factor, pad=((p + 1) // 2, p // 2), data_format=data_format)


def upsample_2d(x: Tensor, k=None, factor: int = 2, gain: float = 1.0,
                data_format: str = "NCHW") -> Tensor:
    """FIR upsample by `factor` (zero-insert + low-pass)."""
    assert isinstance(factor, int) and factor >= 1
    return _resample(x, k, factor, gain, True, data_format)


def downsample_2d(x: Tensor, k=None, factor: int = 2, gain: float = 1.0,
                  data_format: str = "NCHW") -> Tensor:
    """FIR anti-aliased downsample by `factor`."""
    assert isinstance(factor, int) and factor >= 1
    return _resample(x, k, factor, gain, False, data_format)


def upsample_conv_2d(x: Tensor, w: Tensor, k=None, factor: int = 2, gain: float = 1.0) -> Tensor:
    """Transposed conv (stride ``factor``) then the FIR tail; x NCHW, w
    (out_ch, in_ch, kh, kw). The JAX package computes the transposed conv as
    an lhs-dilated correlation with the unflipped weight and full padding,
    which is ``F.conv_transpose2d`` with the weight flipped in space."""
    assert isinstance(factor, int) and factor >= 1
    kh, kw = w.shape[2:]
    assert kh == kw
    k = setup_kernel([1.0] * factor if k is None else k) * (gain * factor**2)
    p = (k.shape[0] - factor) - (kw - 1)
    x = F.conv_transpose2d(x, w.flip((2, 3)).transpose(0, 1), stride=factor)
    return upfirdn2d(x, k, pad=((p + 1) // 2 + factor - 1, p // 2 + 1))


def conv_downsample_2d(x: Tensor, w: Tensor, k=None, factor: int = 2, gain: float = 1.0) -> Tensor:
    """FIR low-pass then a VALID conv of stride ``factor``; x NCHW, w OIHW."""
    assert isinstance(factor, int) and factor >= 1
    kh, kw = w.shape[2:]
    assert kh == kw
    k = setup_kernel([1.0] * factor if k is None else k) * gain
    p = (k.shape[0] - factor) + (kw - 1)
    x = upfirdn2d(x, k, pad=((p + 1) // 2, p // 2))
    return F.conv2d(x, w, stride=factor)


def naive_upsample_2d(x: Tensor, factor: int = 2, data_format: str = "NCHW") -> Tensor:
    """Nearest-neighbour upsampling."""
    if data_format == "NHWC":
        b, h, w, c = x.shape
        x = x.reshape(b, h, 1, w, 1, c).expand(b, h, factor, w, factor, c)
        return x.reshape(b, h * factor, w * factor, c)
    b, c, h, w = x.shape
    x = x.reshape(b, c, h, 1, w, 1).expand(b, c, h, factor, w, factor)
    return x.reshape(b, c, h * factor, w * factor)


def naive_downsample_2d(x: Tensor, factor: int = 2, data_format: str = "NCHW") -> Tensor:
    """Mean over factor x factor blocks."""
    if data_format == "NHWC":
        b, h, w, c = x.shape
        return x.reshape(b, h // factor, factor, w // factor, factor, c).mean(dim=(2, 4))
    b, c, h, w = x.shape
    return x.reshape(b, c, h // factor, factor, w // factor, factor).mean(dim=(3, 5))
