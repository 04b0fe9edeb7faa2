"""Blocks of the NCSN v1/v2 RefineNet family and the plain DDPM resblock,
on NHWC activations.

Counterpart of ``diffsep_tpu/models/legacy_layers.py``: CRPBlock /
CondCRPBlock, RCUBlock / CondRCUBlock, MSFBlock / CondMSFBlock,
RefineBlock / CondRefineBlock, ConvMeanPool / MeanPoolConv / UpsampleConv,
ResidualBlock / ConditionalResidualBlock and ResnetBlockDDPM. No backbone
builds them; they keep the NCSNv2 architecture available.

Every conv is an ``NCSNConv``: a 3x3 stride-1 undilated one runs the hand
kernel of ``ops/conv3x3.py`` on the card (through ``layers.Conv``), a 1x1
one a matrix product, any other (dilated, or another kernel size) the
framework's conv, padded by dilation * (k // 2) as the JAX package pads it
(the reference pads a dilated conv by 1 and crashes on its residual add).

Constructors take the input widths the JAX modules infer, in the
reference's signatures. Where they differ from the JAX package's choices,
the JAX package's stand: MSF resizes bilinearly with aligned corners,
UpsampleConv's cat + PixelShuffle is a per-position channel rotation, not a
nearest upsampling, and the 5x5 pooling of CRP counts the padding in its
average and pads its max with -inf. ``convert.legacy_state_dict_from_jax``
maps a JAX block's parameters onto these modules, and
``reset_parameters(block, generator)`` draws them from a generator.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import layers
from .normalization import ConditionalInstanceNorm2dPlus, InstanceNorm2d, LearnedNorm

Tensor = torch.Tensor


def reset_parameters(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Draw every learned parameter of a legacy block (or norm) anew from
    ``generator``: convs, dense layers and NINs with the DDPM initializer,
    the norms with their own. A block's constructor draws from the global
    generator."""
    for m in module.modules():
        if isinstance(m, (layers.Conv, layers.Dense, layers.NIN, LearnedNorm)):
            m.reset_parameters(generator)


class NCSNConv(layers.Conv):
    """k x k conv on NHWC with an OIHW weight, padded by dilation * (k // 2)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, bias: bool = True,
                 stride: int = 1, dilation: int = 1):
        super().__init__(in_ch, out_ch, 3, bias=bias)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.stride, self.dilation = stride, dilation
        self.reset_parameters()

    def forward(self, x: Tensor) -> Tensor:
        k = self.weight.shape[-1]
        if self.stride == 1 and self.dilation == 1 and k in (1, 3):
            return super().forward(x)
        dt = x.dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(dt), bias, stride=self.stride,
                     padding=self.dilation * (k // 2), dilation=self.dilation)
        return y.permute(0, 2, 3, 1)


def ncsn_conv3x3(in_ch: int, out_ch: int, stride: int = 1, bias: bool = True, dilation: int = 1) -> NCSNConv:
    return NCSNConv(in_ch, out_ch, 3, bias=bias, stride=stride, dilation=dilation)


def _nchw(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)


def _pool5(x: Tensor, maxpool: bool) -> Tensor:
    """5 x 5 stride-1 SAME pooling."""
    if maxpool:
        return _nhwc(F.max_pool2d(_nchw(x), 5, stride=1, padding=2))
    return _nhwc(F.avg_pool2d(_nchw(x), 5, stride=1, padding=2))


def _mean_pool2(h: Tensor) -> Tensor:
    return (h[:, ::2, ::2] + h[:, 1::2, ::2] + h[:, ::2, 1::2] + h[:, 1::2, 1::2]) / 4.0


def _bilinear_resize(x: Tensor, shape) -> Tensor:
    """F.interpolate(mode="bilinear", align_corners=True) to (H, W) = shape."""
    return _nhwc(F.interpolate(_nchw(x), size=(int(shape[0]), int(shape[1])), mode="bilinear",
                               align_corners=True))


class CRPBlock(nn.Module):
    """Chained residual pooling: n_stages of pool then conv, each added."""

    def __init__(self, features: int, n_stages: int, act: Callable = F.relu, maxpool: bool = True):
        super().__init__()
        self.act, self.maxpool = act, maxpool
        self.convs = nn.ModuleList(ncsn_conv3x3(features, features, bias=False) for _ in range(n_stages))

    def forward(self, x: Tensor) -> Tensor:
        x = self.act(x)
        path = x
        for conv in self.convs:
            path = conv(_pool5(path, self.maxpool))
            x = path + x
        return x


class CondCRPBlock(nn.Module):
    """Conditional CRP: norm, average pool, conv per stage."""

    def __init__(self, features: int, n_stages: int, num_classes: int, normalizer: Callable,
                 act: Callable = F.relu):
        super().__init__()
        self.act = act
        self.norms = nn.ModuleList(normalizer(features, num_classes, bias=True) for _ in range(n_stages))
        self.convs = nn.ModuleList(ncsn_conv3x3(features, features, bias=False) for _ in range(n_stages))

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        x = self.act(x)
        path = x
        for norm, conv in zip(self.norms, self.convs):
            path = conv(_pool5(norm(path, y), maxpool=False))
            x = path + x
        return x


class RCUBlock(nn.Module):
    """Residual conv units: n_blocks of (act, conv) x n_stages plus the
    block's input. Modules ``{i}_{j}_conv``, 1-based, as the reference."""

    def __init__(self, features: int, n_blocks: int, n_stages: int, act: Callable = F.relu):
        super().__init__()
        self.act, self.n_blocks, self.n_stages = act, n_blocks, n_stages
        for i in range(n_blocks):
            for j in range(n_stages):
                setattr(self, f"{i + 1}_{j + 1}_conv", ncsn_conv3x3(features, features, bias=False))

    def forward(self, x: Tensor) -> Tensor:
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                x = getattr(self, f"{i + 1}_{j + 1}_conv")(self.act(x))
            x = x + residual
        return x


class CondRCUBlock(nn.Module):
    """Conditional RCU: (norm, act, conv) per stage."""

    def __init__(self, features: int, n_blocks: int, n_stages: int, num_classes: int, normalizer: Callable,
                 act: Callable = F.relu):
        super().__init__()
        self.act, self.n_blocks, self.n_stages = act, n_blocks, n_stages
        for i in range(n_blocks):
            for j in range(n_stages):
                setattr(self, f"{i + 1}_{j + 1}_norm", normalizer(features, num_classes, bias=True))
                setattr(self, f"{i + 1}_{j + 1}_conv", ncsn_conv3x3(features, features, bias=False))

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                x = getattr(self, f"{i + 1}_{j + 1}_norm")(x, y)
                x = getattr(self, f"{i + 1}_{j + 1}_conv")(self.act(x))
            x = x + residual
        return x


class MSFBlock(nn.Module):
    """Multi-scale fusion: a conv per input, each resized to ``shape``,
    summed."""

    def __init__(self, in_planes: Sequence[int], features: int):
        super().__init__()
        self.convs = nn.ModuleList(ncsn_conv3x3(c, features) for c in in_planes)

    def forward(self, xs: Sequence[Tensor], shape) -> Tensor:
        out = None
        for conv, x in zip(self.convs, xs):
            h = _bilinear_resize(conv(x), shape)
            out = h if out is None else out + h
        return out


class CondMSFBlock(nn.Module):
    """Conditional MSF: a norm before each input's conv."""

    def __init__(self, in_planes: Sequence[int], features: int, num_classes: int, normalizer: Callable):
        super().__init__()
        self.norms = nn.ModuleList(normalizer(c, num_classes, bias=True) for c in in_planes)
        self.convs = nn.ModuleList(ncsn_conv3x3(c, features) for c in in_planes)

    def forward(self, xs: Sequence[Tensor], y: Tensor, shape) -> Tensor:
        out = None
        for norm, conv, x in zip(self.norms, self.convs, xs):
            h = _bilinear_resize(conv(norm(x, y)), shape)
            out = h if out is None else out + h
        return out


class RefineBlock(nn.Module):
    """RefineNet block: an RCU per input, MSF where there are several, CRP,
    then output RCUs (three at the end of the net, else one)."""

    def __init__(self, in_planes: Sequence[int], features: int, act: Callable = F.relu, start: bool = False,
                 end: bool = False, maxpool: bool = True):
        super().__init__()
        self.adapt_convs = nn.ModuleList(RCUBlock(c, 2, 2, act) for c in in_planes)
        self.msf = MSFBlock(in_planes, features) if len(in_planes) > 1 else None
        self.crp = CRPBlock(features, 2, act, maxpool)
        self.output_convs = RCUBlock(features, 3 if end else 1, 2, act)

    def forward(self, xs: Sequence[Tensor], output_shape) -> Tensor:
        hs = [adapt(x) for adapt, x in zip(self.adapt_convs, xs)]
        h = self.msf(hs, output_shape) if self.msf is not None else hs[0]
        return self.output_convs(self.crp(h))


class CondRefineBlock(nn.Module):
    """Conditional RefineNet block."""

    def __init__(self, in_planes: Sequence[int], features: int, num_classes: int, normalizer: Callable,
                 act: Callable = F.relu, start: bool = False, end: bool = False):
        super().__init__()
        self.adapt_convs = nn.ModuleList(CondRCUBlock(c, 2, 2, num_classes, normalizer, act) for c in in_planes)
        self.msf = CondMSFBlock(in_planes, features, num_classes, normalizer) if len(in_planes) > 1 else None
        self.crp = CondCRPBlock(features, 2, num_classes, normalizer, act)
        self.output_convs = CondRCUBlock(features, 3 if end else 1, 2, num_classes, normalizer, act)

    def forward(self, xs: Sequence[Tensor], y: Tensor, output_shape) -> Tensor:
        hs = [adapt(x, y) for adapt, x in zip(self.adapt_convs, xs)]
        h = self.msf(hs, y, output_shape) if self.msf is not None else hs[0]
        return self.output_convs(self.crp(h, y), y)


class ConvMeanPool(nn.Module):
    """SAME conv then 2 x 2 mean pooling; ``adjust_padding`` first pads one
    zero row on top and one column on the left."""

    def __init__(self, input_dim: int, output_dim: int, kernel_size: int = 3, biases: bool = True,
                 adjust_padding: bool = False):
        super().__init__()
        self.adjust_padding = adjust_padding
        self.conv = NCSNConv(input_dim, output_dim, kernel_size, bias=biases)

    def forward(self, x: Tensor) -> Tensor:
        if self.adjust_padding:
            x = F.pad(x, (0, 0, 1, 0, 1, 0))
        return _mean_pool2(self.conv(x))


class MeanPoolConv(nn.Module):
    """2 x 2 mean pooling then SAME conv."""

    def __init__(self, input_dim: int, output_dim: int, kernel_size: int = 3, biases: bool = True):
        super().__init__()
        self.conv = NCSNConv(input_dim, output_dim, kernel_size, bias=biases)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv(_mean_pool2(x))


class UpsampleConv(nn.Module):
    """cat([x] * 4, channels) + PixelShuffle(2), then SAME conv. The shuffle
    reads out[2h + i, 2w + j, c] = x[h, w, (4c + 2i + j) mod C]."""

    def __init__(self, input_dim: int, output_dim: int, kernel_size: int = 3, biases: bool = True):
        super().__init__()
        self.conv = NCSNConv(input_dim, output_dim, kernel_size, bias=biases)

    def forward(self, x: Tensor) -> Tensor:
        up = F.pixel_shuffle(torch.cat([_nchw(x)] * 4, dim=1), 2)
        return self.conv(_nhwc(up))


def _residual_convs(block, input_dim: int, output_dim: int, resample, adjust_padding: bool, dilation: int,
                    dilated_shortcut: bool) -> None:
    """conv1, conv2 and the shortcut of the (conditional) residual block."""
    if resample == "down":
        if dilation > 1:
            block.conv1 = ncsn_conv3x3(input_dim, input_dim, dilation=dilation)
            block.conv2 = ncsn_conv3x3(input_dim, output_dim, dilation=dilation)
            block.shortcut = ncsn_conv3x3(input_dim, output_dim, dilation=dilation)
        else:
            block.conv1 = ncsn_conv3x3(input_dim, input_dim)
            block.conv2 = ConvMeanPool(input_dim, output_dim, 3, adjust_padding=adjust_padding)
            block.shortcut = ConvMeanPool(input_dim, output_dim, 1, adjust_padding=adjust_padding)
    elif resample is None:
        block.conv1 = ncsn_conv3x3(input_dim, output_dim, dilation=dilation)
        block.conv2 = ncsn_conv3x3(output_dim, output_dim, dilation=dilation)
        if output_dim == input_dim:
            block.shortcut = None
        elif dilation > 1 and dilated_shortcut:
            block.shortcut = ncsn_conv3x3(input_dim, output_dim, dilation=dilation)
        else:
            block.shortcut = NCSNConv(input_dim, output_dim, 1)
    else:
        raise ValueError("invalid resample value")


class ResidualBlock(nn.Module):
    """NCSNv1/v2 residual block: norm, act, conv, norm, act, conv (or a
    conv and mean pool, resample="down"), plus the shortcut. The norm
    factory takes the width; the default is the affine-free instance
    norm."""

    def __init__(self, input_dim: int, output_dim: int, resample: Optional[str] = None, act: Callable = F.elu,
                 normalization: Optional[Callable] = None, adjust_padding: bool = False, dilation: int = 1):
        super().__init__()
        norm = normalization or InstanceNorm2d
        self.act = act
        self.normalize1 = norm(input_dim)
        self.normalize2 = norm(input_dim if resample == "down" else output_dim)
        _residual_convs(self, input_dim, output_dim, resample, adjust_padding, dilation, dilated_shortcut=True)

    def forward(self, x: Tensor) -> Tensor:
        h = self.conv1(self.act(self.normalize1(x)))
        h = self.conv2(self.act(self.normalize2(h)))
        return (x if self.shortcut is None else self.shortcut(x)) + h


class ConditionalResidualBlock(nn.Module):
    """The class-conditional residual block; the norm factory takes (width,
    num_classes), ConditionalInstanceNorm2dPlus by default. Without
    resampling, a change of width takes a 1x1 shortcut at any dilation."""

    def __init__(self, input_dim: int, output_dim: int, num_classes: int, resample: Optional[str] = None,
                 act: Callable = F.elu, normalization: Optional[Callable] = None, adjust_padding: bool = False,
                 dilation: int = 1):
        super().__init__()
        norm = normalization or ConditionalInstanceNorm2dPlus
        self.act = act
        self.normalize1 = norm(input_dim, num_classes)
        self.normalize2 = norm(input_dim if resample == "down" else output_dim, num_classes)
        _residual_convs(self, input_dim, output_dim, resample, adjust_padding, dilation, dilated_shortcut=False)

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        h = self.conv1(self.act(self.normalize1(x, y)))
        h = self.conv2(self.act(self.normalize2(h, y)))
        return (x if self.shortcut is None else self.shortcut(x)) + h


class ResnetBlockDDPM(nn.Module):
    """The plain DDPM resblock: GroupNorm(32), act, 3x3 conv, plus the
    time embedding's projection, GroupNorm(32), act, dropout (train mode
    only), 3x3 conv (init scale 0), and the input through a 3x3 conv
    (``conv_shortcut``) or NIN where the width changes."""

    def __init__(self, act: Callable, in_ch: int, out_ch: Optional[int] = None, temb_dim: Optional[int] = None,
                 conv_shortcut: bool = False, dropout: float = 0.1):
        super().__init__()
        out_ch = out_ch or in_ch
        self.act = act
        self.GroupNorm_0 = layers.GroupNorm(in_ch, 32, eps=1e-6)
        self.Conv_0 = layers.conv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.Dense_0 = layers.Dense(temb_dim, out_ch)
        self.GroupNorm_1 = layers.GroupNorm(out_ch, 32, eps=1e-6)
        self.Dropout_0 = nn.Dropout(dropout)
        self.Conv_1 = layers.conv3x3(out_ch, out_ch, init_scale=0.0)
        if in_ch != out_ch:
            if conv_shortcut:
                self.Conv_2 = layers.conv3x3(in_ch, out_ch)
            else:
                self.NIN_0 = layers.NIN(in_ch, out_ch)
        reset_parameters(self)

    def forward(self, x: Tensor, temb: Optional[Tensor] = None) -> Tensor:
        h = self.Conv_0(self.act(self.GroupNorm_0(x)))
        if temb is not None:
            h = h + self.Dense_0(self.act(temb))[:, None, None, :]
        h = self.Conv_1(self.Dropout_0(self.act(self.GroupNorm_1(h))))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        elif hasattr(self, "NIN_0"):
            x = self.NIN_0(x)
        return x + h
