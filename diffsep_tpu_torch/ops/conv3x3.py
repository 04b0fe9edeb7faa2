"""3x3 stride-1 SAME convolution on NHWC activations and an HWIO weight.

Counterpart of ``diffsep_tpu/ops/pallas/conv3x3.py``. ``conv3x3`` launches
the hand-written CUDA kernel ``csrc/conv3x3.cu`` for a CUDA tensor and takes
the plain version ``conv3x3_plain`` for a CPU tensor.

The weight is HWIO (3, 3, Cin, Cout) and contiguous, the layout the kernel
reads; ``models.layers.Conv`` keeps the OIHW parameter of the reference
checkpoints and makes this copy once per weight version, not per call.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

Tensor = torch.Tensor

__all__ = ["conv3x3", "conv3x3_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def conv3x3_plain(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None) -> Tensor:
    """Plain version: ``F.conv2d`` on NCHW-permuted tensors."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.permute(3, 2, 0, 1), bias, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def _check(x: Tensor, weight: Tensor, bias: Optional[Tensor]) -> None:
    if x.ndim != 4 or weight.shape[:3] != (3, 3, x.shape[-1]) or weight.ndim != 4:
        raise ValueError(f"conv3x3: x {tuple(x.shape)} and weight {tuple(weight.shape)}")
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise TypeError(f"conv3x3: dtypes {x.dtype}, {weight.dtype}")
    tensors = [x, weight] + ([bias] if bias is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("conv3x3: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("conv3x3: tensors must be contiguous")
    if bias is not None and (bias.shape != (weight.shape[3],) or bias.dtype != x.dtype):
        raise ValueError(f"conv3x3: bias {tuple(bias.shape)} {bias.dtype}")


def conv3x3(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None) -> Tensor:
    """y = conv(x, weight) + bias. x (B, H, W, Cin), weight (3, 3, Cin,
    Cout), bias (Cout,) or None; float32 or bfloat16, accumulated in f32."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: no kernel for device {x.device}")
    _check(x, weight, bias)
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _build.entry("conv3x3", "conv3x3_nhwc", _ARGTYPES)
    err = fn(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(), b, h, w, cin, cout, _DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "conv3x3")
    _build.count_launch("conv3x3", x.shape, cout)
    return out
