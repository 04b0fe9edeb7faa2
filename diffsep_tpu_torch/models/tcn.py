"""Conv-TasNet temporal convolutional network (TCN) mask estimator.

Counterpart of ``diffsep_tpu/models/tcn.py`` (``TemporalConvNet``,
``TemporalBlock``, ``DepthwiseSeparableConv`` with its causal chomp,
``choose_norm`` over gLN/cLN/BN/GN). A library model, as in the JAX package
and the reference: no recipe wires it. Layout (batch, channels, time)
throughout, as the reference computes it; the norms' gamma and beta are
(1, C, 1).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

__all__ = ["ChannelwiseLayerNorm", "GlobalLayerNorm", "choose_norm", "PReLU", "DepthwiseSeparableConv",
           "TemporalBlock", "TemporalConvNet", "EPS"]

# float32 machine epsilon, added to the variance before the square root
EPS = float(np.finfo(np.float32).eps)


class ChannelwiseLayerNorm(nn.Module):
    """cLN: over the channels at each time step."""

    def __init__(self, channel_size: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(1, channel_size, 1))
        self.beta = nn.Parameter(torch.zeros(1, channel_size, 1))

    def forward(self, y: Tensor) -> Tensor:
        mean = y.mean(dim=1, keepdim=True)
        var = y.var(dim=1, keepdim=True, unbiased=False)
        return self.gamma * (y - mean) / torch.sqrt(var + EPS) + self.beta


class GlobalLayerNorm(nn.Module):
    """gLN: over the channels and time together."""

    def __init__(self, channel_size: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(1, channel_size, 1))
        self.beta = nn.Parameter(torch.zeros(1, channel_size, 1))

    def forward(self, y: Tensor) -> Tensor:
        mean = y.mean(dim=(1, 2), keepdim=True)
        var = ((y - mean) ** 2).mean(dim=(1, 2), keepdim=True)
        return self.gamma * (y - mean) / torch.sqrt(var + EPS) + self.beta


def choose_norm(norm_type: str, channel_size: int) -> nn.Module:
    """gLN, cLN, or for "BN"/"GN" one group over (channels, time) with a
    per-channel affine, the JAX package's stateless stand-in for BN."""
    if norm_type == "gLN":
        return GlobalLayerNorm(channel_size)
    if norm_type == "cLN":
        return ChannelwiseLayerNorm(channel_size)
    if norm_type in ("BN", "GN"):
        return nn.GroupNorm(1, channel_size, eps=1e-8)
    raise ValueError("Unsupported normalization type")


# parametric ReLU with one learnable slope, 0.25 at init: torch's defaults
PReLU = nn.PReLU


class DepthwiseSeparableConv(nn.Module):
    """Depthwise dilated conv (chomped to causal) -> PReLU -> norm ->
    pointwise conv."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, padding: int, dilation: int,
                 norm_type: str = "gLN", causal: bool = False):
        super().__init__()
        self.chomp = padding if causal else 0
        self.depthwise_conv = nn.Conv1d(in_channels, in_channels, kernel_size, padding=padding,
                                        dilation=dilation, groups=in_channels, bias=False)
        self.prelu = PReLU()
        self.norm = choose_norm(norm_type, in_channels)
        self.pointwise_conv = nn.Conv1d(in_channels, out_channels, 1, bias=False)

    def forward(self, x: Tensor) -> Tensor:
        h = self.depthwise_conv(x)
        if self.chomp:
            h = h[:, :, :-self.chomp]
        return self.pointwise_conv(self.norm(self.prelu(h)))


class TemporalBlock(nn.Module):
    """1x1 conv -> PReLU -> norm -> depthwise-separable conv, residual."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, padding: int, dilation: int,
                 norm_type: str = "gLN", causal: bool = False):
        super().__init__()
        self.conv1x1 = nn.Conv1d(in_channels, out_channels, 1, bias=False)
        self.prelu = PReLU()
        self.norm = choose_norm(norm_type, out_channels)
        self.dsconv = DepthwiseSeparableConv(out_channels, in_channels, kernel_size, padding, dilation,
                                             norm_type, causal)

    def forward(self, x: Tensor) -> Tensor:
        return self.dsconv(self.norm(self.prelu(self.conv1x1(x)))) + x


_MASK_NONLINEAR = {
    "softmax": lambda s: F.softmax(s, dim=1),
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}


class TemporalConvNet(nn.Module):
    """Conv-TasNet mask estimator: forward(mixture_w (batch, N, K)) ->
    masks (batch, C, N, K). N encoder channels, B bottleneck, H block
    channels, P kernel size, X blocks per repeat, R repeats, C sources."""

    def __init__(self, N: int, B: int, H: int, P: int, X: int, R: int, C: int, norm_type: str = "gLN",
                 causal: bool = False, mask_nonlinear: str = "relu"):
        super().__init__()
        if mask_nonlinear not in _MASK_NONLINEAR:
            raise ValueError("Unsupported mask non-linear function")
        self.C, self.mask_nonlinear = C, mask_nonlinear
        self.layer_norm = ChannelwiseLayerNorm(N)
        self.bottleneck_conv1x1 = nn.Conv1d(N, B, 1, bias=False)

        def block(xi):
            dilation = 2 ** xi
            padding = (P - 1) * dilation if causal else (P - 1) * dilation // 2
            return TemporalBlock(B, H, P, padding, dilation, norm_type, causal)

        self.repeats = nn.ModuleList(nn.ModuleList(block(xi) for xi in range(X)) for _ in range(R))
        self.mask_conv1x1 = nn.Conv1d(B, C * N, 1, bias=False)

    def forward(self, mixture_w: Tensor) -> Tensor:
        m, n, k = mixture_w.shape
        x = self.bottleneck_conv1x1(self.layer_norm(mixture_w))
        for repeat in self.repeats:
            for blk in repeat:
                x = blk(x)
        score = self.mask_conv1x1(x).view(m, self.C, n, k)
        return _MASK_NONLINEAR[self.mask_nonlinear](score)
