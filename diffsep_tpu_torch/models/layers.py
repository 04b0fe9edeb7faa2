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
``ops/conv3x3.py`` on the GPU. Where the JAX package gives a conv no
compute dtype (the ``fir=False`` resample convs, and NCSN++'s last conv
when ``progressive`` is not "output_skip"), flax promotes a bf16 input and
the f32 weight to f32; the callers here cast such inputs to f32, so the
port computes in the same dtypes.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv3x3 as conv3x3_ops
from ..ops import resampling

Tensor = torch.Tensor


def _lrelu(x: Tensor) -> Tensor:
    return F.leaky_relu(x, 0.2)


_ACTS = {"elu": F.elu, "relu": F.relu, "lrelu": _lrelu, "swish": F.silu, "silu": F.silu}


def get_act(name: str):
    """The activation named ``name`` (the JAX package's registry)."""
    return _ACTS[name]


def get_timestep_embedding(timesteps: Tensor, embedding_dim: int, max_positions: int = 10000) -> Tensor:
    """Sinusoidal positional embedding of (batch,) timesteps, float32."""
    half_dim = embedding_dim // 2
    emb = math.log(max_positions) / (half_dim - 1)
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=timesteps.device) * -emb)
    emb = timesteps.float()[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


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


_weights_in_graph = False


@contextlib.contextmanager
def weights_in_graph():
    """Inside the block every 3x3 conv makes its kernel weight from the
    parameter on each call, as in grad mode, instead of taking the copy it
    keeps: that copy is keyed on the parameter's data pointer, which a
    traced tensor does not have. ``export.export_separator`` traces the
    score model inside it, so the weight's permute and cast are nodes of the
    exported program."""
    global _weights_in_graph
    prev, _weights_in_graph = _weights_in_graph, True
    try:
        yield
    finally:
        _weights_in_graph = prev


class Conv(nn.Module):
    """k x k stride-1 SAME convolution (k = 1 or 3) on NHWC, OIHW weight;
    with ``stride=2`` a 3x3 VALID convolution of stride 2, the framework's
    (cuDNN on the card: no TPU kernel computes it).

    The 3x3 case runs ``ops.conv3x3.conv3x3``: the CUDA kernel on the GPU,
    ``F.conv2d`` on the CPU. Its weight goes in as a contiguous HWIO copy in
    the compute dtype. Without grad mode it is made once per weight version
    (a load or an optimizer step bumps it) and kept, not rebuilt on every
    call; in grad mode, inside ``weights_in_graph``, and where
    ``keep_weight_copy`` is off, it is made on every call, differentiably.
    FSDP turns ``keep_weight_copy`` off (``parallel/mesh.shard_fsdp``): its
    all-gather refills the parameter in place without bumping the version
    the copy is keyed on. The 1x1 case is a plain matrix product.
    """

    keep_weight_copy = True

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 init_scale: float = 1.0, bias: bool = True, stride: int = 1):
        super().__init__()
        if kernel_size not in (1, 3):
            raise ValueError(f"kernel_size must be 1 or 3, got {kernel_size}")
        self.init_scale = init_scale
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self._hwio = None  # (key, weight copy) for the 3x3 kernel

    def reset_parameters(self, generator=None) -> None:
        default_init_(self.weight, self.init_scale, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def _kernel_weight(self, dt: torch.dtype) -> Tensor:
        w = self.weight
        if _weights_in_graph or not self.keep_weight_copy or (torch.is_grad_enabled() and w.requires_grad):
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
        if self.stride != 1:
            y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(dt), bias, stride=self.stride)
            return y.permute(0, 2, 3, 1)
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


def norm_act(gn: GroupNorm, act, x: Tensor) -> Tensor:
    """GroupNorm then the activation, in x's dtype."""
    return act(gn(x)).to(x.dtype)


class Combine(nn.Module):
    """Combine a skip pyramid (dim1 channels) with the trunk (dim2): a 1x1
    conv to dim2, then summed with or concatenated before the trunk."""

    def __init__(self, dim1: int, dim2: int, method: str = "cat"):
        super().__init__()
        if method not in ("cat", "sum"):
            raise ValueError(f"Method {method} not recognized.")
        self.method = method
        self.Conv_0 = conv1x1(dim1, dim2)

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        h = self.Conv_0(x)
        if self.method == "cat":
            return torch.cat([h, y], dim=-1)
        return h + y


# Above this many grid tokens attention takes the blockwise online-softmax
# path, whose memory is linear in the tokens (the JAX package's threshold:
# 4096 tokens, a 64 MB float32 score matrix per batch row; 5 s is 320).
# DIFFSEP_ATTN_BLOCKWISE=1/0 forces either path.
ATTN_BLOCKWISE_THRESHOLD = 4096


def attn_blockwise(n_tokens: int) -> bool:
    flag = os.environ.get("DIFFSEP_ATTN_BLOCKWISE", "")
    if flag == "1":
        return True
    if flag == "0":
        return False
    return n_tokens > ATTN_BLOCKWISE_THRESHOLD


def blockwise_attention(q: Tensor, k: Tensor, v: Tensor, scale: float,
                        q_block: int = 512, k_block: int = 512) -> Tensor:
    """softmax(q k^T * scale) v over (batch, n, c) tensors, float32 out,
    computed by the online-softmax recurrence over (q_block, k_block) tiles
    as the JAX package's ``blockwise_attention`` does: scores and the
    softmax statistics in float32, the probability tile cast to v's dtype
    before its product, keys past n masked. Only one score tile is live at a
    time. The tile loops are Python loops, unrolled by ``torch.export``."""
    b, n, c = q.shape
    nq, nk = -(-n // q_block), -(-n // k_block)
    q = F.pad(q, (0, 0, 0, nq * q_block - n))
    k = F.pad(k, (0, 0, 0, nk * k_block - n))
    v = F.pad(v, (0, 0, 0, nk * k_block - n))
    # every k tile holds a valid key, so each score row has a finite max
    valid = torch.arange(k_block, device=q.device) < n - (nk - 1) * k_block
    out = []
    for i in range(nq):
        q_t = q[:, i * q_block:(i + 1) * q_block].float()
        m = torch.full((b, q_block), -math.inf, device=q.device)
        l = torch.zeros((b, q_block), device=q.device)
        acc = torch.zeros((b, q_block, c), device=q.device)
        for j in range(nk):
            k_t = k[:, j * k_block:(j + 1) * k_block].float()
            v_t = v[:, j * k_block:(j + 1) * k_block]
            s = (q_t @ k_t.transpose(1, 2)) * scale
            if j == nk - 1:
                s = s.masked_fill(~valid, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)  # first tile: exp(-inf) = 0
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + p.to(v_t.dtype).float() @ v_t.float()
            m = m_new
        out.append(acc / l[..., None])
    return torch.cat(out, dim=1)[:, :n]


class AttnBlockpp(nn.Module):
    """Self-attention over the (freq, frames) grid; scores and softmax in
    float32, the result cast back to the activation dtype. Past
    ATTN_BLOCKWISE_THRESHOLD tokens it runs ``blockwise_attention``. With
    ``skip_rescale`` the residual is divided by sqrt(2)."""

    def __init__(self, channels: int, skip_rescale: bool = False, init_scale: float = 0.0):
        super().__init__()
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = group_norm(channels)
        self.NIN_0 = NIN(channels, channels)
        self.NIN_1 = NIN(channels, channels)
        self.NIN_2 = NIN(channels, channels)
        self.NIN_3 = NIN(channels, channels, init_scale=init_scale)

    def forward(self, x: Tensor) -> Tensor:
        b, hd, wd, c = x.shape
        h = self.GroupNorm_0(x)
        q = self.NIN_0(h).reshape(b, hd * wd, c)
        k = self.NIN_1(h).reshape(b, hd * wd, c)
        v = self.NIN_2(h).reshape(b, hd * wd, c)
        if attn_blockwise(hd * wd):
            h = blockwise_attention(q, k, v, int(c) ** (-0.5)).to(x.dtype)
        else:
            w = torch.softmax((q.float() @ k.float().transpose(1, 2)) * (int(c) ** (-0.5)), dim=-1)
            h = (w.to(x.dtype).float() @ v.float()).to(x.dtype)
        h = self.NIN_3(h.reshape(b, hd, wd, c))
        if not self.skip_rescale:
            return x + h
        return ((x + h) / np.sqrt(2.0)).to(x.dtype)


class FusedResampleConv(nn.Module):
    """StyleGAN2 3x3 conv with fused FIR up- or downsampling (``Conv2d_0``
    of the with_conv FIR resamplers): weight OIHW (out_ch, in_ch, 3, 3),
    NHWC in and out, computed in the input's dtype."""

    def __init__(self, in_ch: int, out_ch: int, up: bool, resample_kernel: Sequence[float] = (1, 3, 3, 1)):
        super().__init__()
        self.up = up
        self.resample_kernel = list(resample_kernel)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def reset_parameters(self, generator=None) -> None:
        # the JAX package draws this OIHW weight with flax's default axes
        # (in -2, out -1), which here are the two spatial ones
        default_init_(self.weight, 1.0, generator, in_axis=2, out_axis=3)
        nn.init.zeros_(self.bias)

    def forward(self, x: Tensor) -> Tensor:
        dt = x.dtype
        resample = resampling.upsample_conv_2d if self.up else resampling.conv_downsample_2d
        x = resample(x.permute(0, 3, 1, 2), self.weight.to(dt), k=self.resample_kernel)
        return x.permute(0, 2, 3, 1) + self.bias.to(dt)


class Upsample(nn.Module):
    """2x upsampling: nearest (``fir=False``) or FIR, optionally with a conv
    (a 3x3 conv after the nearest one, in float32 as in the JAX package; the
    fused transposed conv with FIR)."""

    def __init__(self, in_ch: Optional[int] = None, out_ch: Optional[int] = None, with_conv: bool = False,
                 fir: bool = False, fir_kernel: Sequence[float] = (1, 3, 3, 1)):
        super().__init__()
        out_ch = out_ch or in_ch
        self.with_conv, self.fir = with_conv, fir
        self.fir_kernel = list(fir_kernel)
        if with_conv and fir:
            self.Conv2d_0 = FusedResampleConv(in_ch, out_ch, up=True, resample_kernel=fir_kernel)
        elif with_conv:
            self.Conv_0 = conv3x3(in_ch, out_ch)

    def forward(self, x: Tensor) -> Tensor:
        if not self.fir:
            x = resampling.naive_upsample_2d(x, data_format="NHWC")
            return self.Conv_0(x.float()) if self.with_conv else x
        if self.with_conv:
            return self.Conv2d_0(x)
        return resampling.upsample_2d(x, self.fir_kernel, factor=2, data_format="NHWC")


class Downsample(nn.Module):
    """2x downsampling: 2x2 mean (``fir=False``) or FIR; with a conv, a
    3x3 stride-2 conv after padding the bottom and right by one (in float32
    as in the JAX package), or the fused FIR conv."""

    def __init__(self, in_ch: Optional[int] = None, out_ch: Optional[int] = None, with_conv: bool = False,
                 fir: bool = False, fir_kernel: Sequence[float] = (1, 3, 3, 1)):
        super().__init__()
        out_ch = out_ch or in_ch
        self.with_conv, self.fir = with_conv, fir
        self.fir_kernel = list(fir_kernel)
        if with_conv and fir:
            self.Conv2d_0 = FusedResampleConv(in_ch, out_ch, up=False, resample_kernel=fir_kernel)
        elif with_conv:
            self.Conv_0 = Conv(in_ch, out_ch, 3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        if not self.fir:
            if self.with_conv:
                return self.Conv_0(F.pad(x.float(), (0, 0, 0, 1, 0, 1)))
            return resampling.naive_downsample_2d(x, data_format="NHWC")
        if self.with_conv:
            return self.Conv2d_0(x)
        return resampling.downsample_2d(x, self.fir_kernel, factor=2, data_format="NHWC")


def _residual(x: Tensor, h: Tensor, skip_rescale: bool) -> Tensor:
    if not skip_rescale:
        return x + h
    return ((x + h) / np.sqrt(2.0)).to(h.dtype)


class ResnetBlockDDPMpp(nn.Module):
    """DDPM-style residual block: GroupNorm, act, 3x3 conv (plus the
    embedded time where ``temb_dim`` is given) twice, and an ``NIN_0``
    shortcut where the channels change."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None, temb_dim: Optional[int] = None,
                 act: str = "swish", skip_rescale: bool = False, init_scale: float = 0.0):
        super().__init__()
        out_ch = out_ch or in_ch
        self.act = get_act(act)
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = group_norm(in_ch)
        self.Conv_0 = conv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.Dense_0 = Dense(temb_dim, out_ch)
        self.GroupNorm_1 = group_norm(out_ch)
        self.Conv_1 = conv3x3(out_ch, out_ch, init_scale=init_scale)
        if in_ch != out_ch:
            self.NIN_0 = NIN(in_ch, out_ch)

    def forward(self, x: Tensor, temb: Optional[Tensor] = None) -> Tensor:
        h = self.Conv_0(norm_act(self.GroupNorm_0, self.act, x))
        if temb is not None:
            h = h + self.Dense_0(self.act(temb).to(h.dtype))[:, None, None, :]
        h = self.Conv_1(norm_act(self.GroupNorm_1, self.act, h))
        if hasattr(self, "NIN_0"):
            x = self.NIN_0(x)
        return _residual(x, h, self.skip_rescale)


class ResnetBlockBigGANpp(nn.Module):
    """BigGAN-style residual block, optionally resampling inside (FIR with
    ``fir``, else nearest up / 2x2 average down), with a 1x1 ``Conv_2``
    shortcut where the channels change or it resamples."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None, temb_dim: Optional[int] = None,
                 act: str = "swish", up: bool = False, down: bool = False, fir: bool = False,
                 fir_kernel: Sequence[float] = (1, 3, 3, 1), skip_rescale: bool = True,
                 init_scale: float = 0.0):
        super().__init__()
        out_ch = out_ch or in_ch
        self.act = get_act(act)
        self.up, self.down, self.fir, self.skip_rescale = up, down, fir, skip_rescale
        self.fir_kernel = list(fir_kernel)
        self.GroupNorm_0 = group_norm(in_ch)
        self.Conv_0 = conv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.Dense_0 = Dense(temb_dim, out_ch)
        self.GroupNorm_1 = group_norm(out_ch)
        self.Conv_1 = conv3x3(out_ch, out_ch, init_scale=init_scale)
        if in_ch != out_ch or up or down:
            self.Conv_2 = conv1x1(in_ch, out_ch)

    def _resample(self, x: Tensor) -> Tensor:
        if self.up:
            if self.fir:
                return resampling.upsample_2d(x, self.fir_kernel, factor=2, data_format="NHWC")
            return resampling.naive_upsample_2d(x, data_format="NHWC")
        if self.fir:
            return resampling.downsample_2d(x, self.fir_kernel, factor=2, data_format="NHWC")
        return resampling.naive_downsample_2d(x, data_format="NHWC")

    def forward(self, x: Tensor, temb: Optional[Tensor] = None) -> Tensor:
        h = norm_act(self.GroupNorm_0, self.act, x)
        if self.up or self.down:
            h, x = self._resample(h), self._resample(x)
        h = self.Conv_0(h)
        if temb is not None:
            h = h + self.Dense_0(self.act(temb).to(h.dtype))[:, None, None, :]
        h = self.Conv_1(norm_act(self.GroupNorm_1, self.act, h))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return _residual(x, h, self.skip_rescale)
