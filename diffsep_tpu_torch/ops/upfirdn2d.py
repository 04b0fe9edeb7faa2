"""upfirdn2d: zero-insert upsample -> pad -> FIR filter -> downsample.

Counterpart of the general path of ``diffsep_tpu/ops/upfirdn2d.py``
(``_upfirdn2d_conv``), in plain PyTorch. Per channel and separately along H
and W:

  1. zero-insert upsample by `up` (x[i] -> position i*up, length n*up)
  2. pad by (pad0, pad1); a negative pad crops
  3. convolve with the kernel (correlation with the flipped kernel)
  4. keep every `down`-th sample

  out_size = (in * up + pad0 + pad1 - kernel) // down + 1

It is the plain version of the FIR 2x resampling kernels in
``fir_resample2x.py`` and serves any other factor on the CPU.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

__all__ = ["upfirdn2d", "out_size"]


def out_size(n: int, up: int, down: int, pad0: int, pad1: int, k: int) -> int:
    return (n * up + pad0 + pad1 - k) // down + 1


@functools.lru_cache(maxsize=256)
def _flipped(kernel: bytes, shape: tuple, device: torch.device, dtype: torch.dtype) -> Tensor:
    """The float32 kernel (its bytes and shape), flipped for F.conv2d, on
    ``device`` in ``dtype``: made once, so that a call on the card copies
    nothing from the host and does not wait for the stream."""
    k = torch.from_numpy(np.frombuffer(kernel, np.float32).reshape(shape).copy())
    return torch.flip(k, (0, 1)).to(device=device, dtype=dtype)


def _as_tuple2(v):
    if isinstance(v, (tuple, list)):
        assert len(v) == 2
        return tuple(v)
    return (v, v)


def upfirdn2d(
    x: Tensor, kernel, up=1, down=1, pad=(0, 0), data_format: str = "NCHW"
) -> Tensor:
    """x: (B, C, H, W) or (B, H, W, C) with data_format="NHWC"; kernel
    (kh, kw); scalar or (y, x) up/down; pad (p0, p1) for both axes or
    (py0, py1, px0, px1)."""
    up_y, up_x = _as_tuple2(up)
    down_y, down_x = _as_tuple2(down)
    py0, py1, px0, px1 = (pad[0], pad[1], pad[0], pad[1]) if len(pad) == 2 else pad
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    b, c, h, w = x.shape
    if up_y > 1 or up_x > 1:
        z = x.new_zeros((b, c, h, up_y, w, up_x))
        z[:, :, :, 0, :, 0] = x
        x = z.reshape(b, c, h * up_y, w * up_x)
    # F.pad crops for negative amounts as well
    x = F.pad(x, (px0, px1, py0, py1))
    k = np.asarray(kernel, np.float32)
    k = _flipped(k.tobytes(), k.shape, x.device, x.dtype)
    kh, kw = k.shape
    out = F.conv2d(x, k.expand(c, 1, kh, kw), stride=(down_y, down_x), groups=c)
    if data_format == "NHWC":
        out = out.permute(0, 2, 3, 1).contiguous()
    return out
