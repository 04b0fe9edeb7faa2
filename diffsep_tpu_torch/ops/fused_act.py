"""Bias add, LeakyReLU and a gain in one expression.

Counterpart of ``diffsep_tpu/ops/fused_act.py``, the reference's
``fused_leaky_relu`` (a CUDA op there that NCSN++ never calls). The JAX
package computes it with plain array ops, and so does the port: an
elementwise chain with no TPU kernel behind it. Its gradient is autograd's.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

Tensor = torch.Tensor

__all__ = ["fused_leaky_relu", "FusedLeakyReLU"]


def fused_leaky_relu(x: Tensor, bias: Optional[Tensor] = None, negative_slope: float = 0.2,
                     scale: float = 2.0**0.5) -> Tensor:
    """leaky_relu(x + bias) * scale, the bias broadcast over axis 1."""
    if bias is not None:
        x = x + bias.reshape(1, -1, *(1,) * (x.ndim - 2))
    return torch.where(x >= 0, x, x * negative_slope) * scale


class FusedLeakyReLU(nn.Module):
    """``fused_leaky_relu`` with a (channels,) bias parameter."""

    def __init__(self, bias: Tensor, negative_slope: float = 0.2, scale: float = 2.0**0.5):
        super().__init__()
        self.bias = nn.Parameter(torch.as_tensor(bias, dtype=torch.float32).clone())
        self.negative_slope = negative_slope
        self.scale = scale

    def forward(self, x: Tensor) -> Tensor:
        return fused_leaky_relu(x, self.bias.to(x.dtype), self.negative_slope, self.scale)
