"""Layer library of NCSN++ on NHWC activations.

Counterpart of ``diffsep_tpu/models/layers.py``. Module and parameter names
follow the reference torch checkpoint layout (``Conv_0.weight`` OIHW,
``Dense_0.weight`` (out, in), ``GroupNorm_0.weight``, ``NIN_0.W``, ...) so
a converted state dict loads with ``strict=True``.

Parameters stay float32 and every module computes in its input's dtype,
which is what the JAX package's explicit per-layer dtypes amount to in
NCSN++: bfloat16 inside the backbone when it computes in bfloat16, float32
for the time embedding and the output projection. GroupNorm statistics and
attention scores are float32. A 3x3 conv runs the CUDA kernel of
``ops/conv3x3.py`` on the GPU.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv3x3 as conv3x3_ops
from ..ops import resampling

Tensor = torch.Tensor


def default_init_(w: Tensor, scale: float = 1.0, generator=None,
                  in_axis: int = 1, out_axis: int = 0) -> None:
    """DDPM initializer: variance scaling, fan_avg, uniform. The default axes
    are those of torch layouts ((out, in) and OIHW)."""
    scale = 1e-10 if scale == 0 else scale
    receptive = w.numel() // (w.shape[in_axis] * w.shape[out_axis])
    fan_in, fan_out = w.shape[in_axis] * receptive, w.shape[out_axis] * receptive
    limit = math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2.0))
    with torch.no_grad():
        w.uniform_(-limit, limit, generator=generator)


class GaussianFourierProjection(nn.Module):
    """Fixed Gaussian Fourier features of the (log) noise level."""

    def __init__(self, embedding_size: int = 256, scale: float = 1.0):
        super().__init__()
        self.scale = scale
        self.W = nn.Parameter(torch.empty(embedding_size), requires_grad=False)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.W.normal_(0.0, self.scale, generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        x_proj = x[:, None] * self.W[None, :] * 2 * np.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class Dense(nn.Module):
    """Linear layer, weight (out, in)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def reset_parameters(self, generator=None) -> None:
        default_init_(self.weight, 1.0, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: Tensor) -> Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class NIN(nn.Module):
    """1x1 channel mix on the last axis: x @ W + b, W (in, out)."""

    def __init__(self, in_dim: int, num_units: int, init_scale: float = 0.1):
        super().__init__()
        self.init_scale = init_scale
        self.W = nn.Parameter(torch.empty(in_dim, num_units))
        self.b = nn.Parameter(torch.zeros(num_units))

    def reset_parameters(self, generator=None) -> None:
        default_init_(self.W, self.init_scale, generator, in_axis=0, out_axis=1)
        nn.init.zeros_(self.b)

    def forward(self, x: Tensor) -> Tensor:
        return x @ self.W.to(x.dtype) + self.b.to(x.dtype)


class Conv(nn.Module):
    """k x k stride-1 SAME convolution (k = 1 or 3) on NHWC, OIHW weight.

    The 3x3 case runs ``ops.conv3x3.conv3x3``: the CUDA kernel on the GPU,
    ``F.conv2d`` on the CPU. Its weight goes in as a contiguous HWIO copy in
    the compute dtype. Without grad mode it is made once per weight version
    (a load or an optimizer step bumps it) and kept, not rebuilt on every
    call; in grad mode it is made on every call, differentiably. The 1x1
    case is a plain matrix product.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 init_scale: float = 1.0, bias: bool = True):
        super().__init__()
        if kernel_size not in (1, 3):
            raise ValueError(f"kernel_size must be 1 or 3, got {kernel_size}")
        self.init_scale = init_scale
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self._hwio = None  # (key, weight copy) for the 3x3 kernel

    def reset_parameters(self, generator=None) -> None:
        default_init_(self.weight, self.init_scale, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def _kernel_weight(self, dt: torch.dtype) -> Tensor:
        w = self.weight
        if torch.is_grad_enabled() and w.requires_grad:
            # training: a differentiable copy, so that dW reaches the
            # float32 parameter
            return w.permute(2, 3, 1, 0).to(dt).contiguous()
        key = (dt, w.device, w.data_ptr(), w._version)
        if self._hwio is None or self._hwio[0] != key:
            with torch.no_grad():
                self._hwio = (key, w.detach().permute(2, 3, 1, 0).to(dt).contiguous())
        return self._hwio[1]

    def forward(self, x: Tensor) -> Tensor:
        dt = x.dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        if self.weight.shape[-1] == 3:
            return conv3x3_ops.conv3x3(x.contiguous(), self._kernel_weight(dt), bias)
        y = x @ self.weight[:, :, 0, 0].t().to(dt)
        return y + bias if bias is not None else y


def conv1x1(in_ch: int, out_ch: int, init_scale: float = 1.0, bias: bool = True) -> Conv:
    return Conv(in_ch, out_ch, 1, init_scale=init_scale, bias=bias)


def conv3x3(in_ch: int, out_ch: int, init_scale: float = 1.0, bias: bool = True) -> Conv:
    return Conv(in_ch, out_ch, 3, init_scale=init_scale, bias=bias)


class GroupNorm(nn.Module):
    """Group normalization over NHWC with float32 statistics, output in the
    input's dtype. The variance is the one-read E[x^2] - E[x]^2, clamped at
    0, and the affine is folded into one x * a + b pass, as in the JAX
    package."""

    def __init__(self, num_channels: int, num_groups: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: Tensor) -> Tensor:
        b, c, g = x.shape[0], x.shape[-1], self.num_groups
        xg = x.float().reshape(b, -1, g, c // g)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        mean2 = xg.square().mean(dim=(1, 3), keepdim=True)
        inv = torch.rsqrt(torch.clamp(mean2 - mean.square(), min=0.0) + self.eps)
        a = inv * self.weight.float().reshape(g, c // g)
        shift = self.bias.float().reshape(g, c // g) - mean * a
        return (xg * a + shift).to(x.dtype).reshape(x.shape)


def group_norm(channels: int) -> GroupNorm:
    """GroupNorm(min(c // 4, 32), eps=1e-6) as used throughout NCSN++."""
    return GroupNorm(channels, num_groups=max(min(channels // 4, 32), 1), eps=1e-6)


class Combine(nn.Module):
    """Combine a skip pyramid with the trunk by sum (NCSN++'s
    progressive_combine="sum")."""

    def __init__(self, dim1: int, dim2: int):
        super().__init__()
        self.Conv_0 = conv1x1(dim1, dim2)

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        return self.Conv_0(x) + y


class AttnBlockpp(nn.Module):
    """Self-attention over the (freq, frames) grid; scores and softmax in
    float32, the result cast back to the activation dtype. The residual is
    rescaled by 1/sqrt(2) (skip_rescale)."""

    def __init__(self, channels: int, init_scale: float = 0.0):
        super().__init__()
        self.GroupNorm_0 = group_norm(channels)
        self.NIN_0 = NIN(channels, channels)
        self.NIN_1 = NIN(channels, channels)
        self.NIN_2 = NIN(channels, channels)
        self.NIN_3 = NIN(channels, channels, init_scale=init_scale)

    def forward(self, x: Tensor) -> Tensor:
        b, hd, wd, c = x.shape
        h = self.GroupNorm_0(x)
        q = self.NIN_0(h).reshape(b, hd * wd, c).float()
        k = self.NIN_1(h).reshape(b, hd * wd, c).float()
        v = self.NIN_2(h).reshape(b, hd * wd, c)
        w = torch.softmax((q @ k.transpose(1, 2)) * (int(c) ** (-0.5)), dim=-1)
        h = (w.to(x.dtype).float() @ v.float()).to(x.dtype).reshape(b, hd, wd, c)
        h = self.NIN_3(h)
        return ((x + h) / np.sqrt(2.0)).to(x.dtype)


class Upsample(nn.Module):
    """2x FIR upsampling without conv (the only form NCSN++ output_skip
    uses)."""

    def __init__(self, fir_kernel: Sequence[float] = (1, 3, 3, 1)):
        super().__init__()
        self.fir_kernel = list(fir_kernel)

    def forward(self, x: Tensor) -> Tensor:
        return resampling.upsample_2d(x, self.fir_kernel, factor=2, data_format="NHWC")


class Downsample(nn.Module):
    """2x FIR downsampling without conv (the only form NCSN++ input_skip
    uses)."""

    def __init__(self, fir_kernel: Sequence[float] = (1, 3, 3, 1)):
        super().__init__()
        self.fir_kernel = list(fir_kernel)

    def forward(self, x: Tensor) -> Tensor:
        return resampling.downsample_2d(x, self.fir_kernel, factor=2, data_format="NHWC")


class ResnetBlockBigGANpp(nn.Module):
    """BigGAN-style residual block with in-block FIR resampling (fir=True),
    swish activations and a 1/sqrt(2) rescaled residual (skip_rescale)."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None, temb_dim: Optional[int] = None,
                 up: bool = False, down: bool = False, fir_kernel: Sequence[float] = (1, 3, 3, 1),
                 init_scale: float = 0.0):
        super().__init__()
        out_ch = out_ch or in_ch
        self.up, self.down = up, down
        self.fir_kernel = list(fir_kernel)
        self.GroupNorm_0 = group_norm(in_ch)
        self.Conv_0 = conv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.Dense_0 = Dense(temb_dim, out_ch)
        self.GroupNorm_1 = group_norm(out_ch)
        self.Conv_1 = conv3x3(out_ch, out_ch, init_scale=init_scale)
        if in_ch != out_ch or up or down:
            self.Conv_2 = conv1x1(in_ch, out_ch)

    def forward(self, x: Tensor, temb: Optional[Tensor] = None) -> Tensor:
        h = F.silu(self.GroupNorm_0(x)).to(x.dtype)
        if self.up:
            h = resampling.upsample_2d(h, self.fir_kernel, factor=2, data_format="NHWC")
            x = resampling.upsample_2d(x, self.fir_kernel, factor=2, data_format="NHWC")
        elif self.down:
            h = resampling.downsample_2d(h, self.fir_kernel, factor=2, data_format="NHWC")
            x = resampling.downsample_2d(x, self.fir_kernel, factor=2, data_format="NHWC")
        h = self.Conv_0(h)
        if temb is not None:
            h = h + self.Dense_0(F.silu(temb))[:, None, None, :]
        h = F.silu(self.GroupNorm_1(h)).to(h.dtype)
        h = self.Conv_1(h)
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return ((x + h) / np.sqrt(2.0)).to(h.dtype)
