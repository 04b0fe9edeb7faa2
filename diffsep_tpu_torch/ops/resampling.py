"""FIR up/down-sampling wrappers (StyleGAN2 style).

Counterpart of ``upsample_2d``/``downsample_2d``/``setup_kernel`` in
``diffsep_tpu/ops/resampling.py``. A factor-2 call with a separable 4-tap
filter on NHWC data, which is every call NCSN++ makes, goes to the FIR 2x
kernel (``fir_resample2x``) with the 1-D taps normalized per axis; any other
call runs the plain ``upfirdn2d`` on the 2-D ``setup_kernel`` and is served
on the CPU only.
"""
from __future__ import annotations

import numpy as np
import torch

from . import fir_resample2x
from .upfirdn2d import upfirdn2d

Tensor = torch.Tensor

__all__ = ["setup_kernel", "upsample_2d", "downsample_2d"]


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
    if x.device.type != "cpu":
        raise NotImplementedError(
            "only factor-2, separable 4-tap NHWC resampling has a GPU kernel"
        )
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
