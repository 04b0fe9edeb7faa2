"""DiffuSE / CDiffuSE backbone: a WaveNet-style stack of gated dilated 1-D
convolutions.

Counterpart of ``diffsep_tpu/models/cdiffuse.py``: the step embedding (a
sinusoid table, linearly interpolated for continuous diffusion times), the
gated dilated ``ResidualBlock`` with its conditioner convolution, the skip
sum over sqrt(layers) and a zero-initialized output projection, so that a
freshly built model returns exactly 0. The interface keeps the JAX layout,
(batch, chan, time) in and out; inside, every convolution is an NCL
``F.conv1d`` in float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

__all__ = ["DiffusionEmbedding", "ResidualBlock", "DiffuSE"]


def _embedding_table(max_steps: int) -> np.ndarray:
    """The (max_steps, 128) sinusoid table, in float32 arithmetic as the
    reference builds it: its arguments reach ~5e5, where the sine of the
    float32-rounded frequency differs by O(1) from the float64 one, so it is
    built by this numpy code on the host and never recomputed on a device."""
    steps = np.arange(max_steps, dtype=np.float32)[:, None]
    dims = np.arange(64, dtype=np.float32)[None, :]
    exponent = dims * np.float32(4.0) / np.float32(63.0)
    freqs = (10.0 ** exponent.astype(np.float64)).astype(np.float32)
    table = steps * freqs
    return np.concatenate([np.sin(table), np.cos(table)], axis=1).astype(np.float32)


def _trunc_normal_fan_in_(w: Tensor, gain: float, generator=None, fan_in=None) -> None:
    """flax's variance_scaling(gain, "fan_in", "truncated_normal"):
    he_normal is gain 2, lecun_normal gain 1; fan_in defaults to
    ``in x receptive field`` of a torch (out, in, ...) weight."""
    fan_in = fan_in or w[0].numel()
    std = math.sqrt(gain / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def _init_linear(m: nn.Linear, generator=None) -> None:
    _trunc_normal_fan_in_(m.weight, 1.0, generator)
    nn.init.zeros_(m.bias)


def _init_conv(m: nn.Conv1d, generator=None) -> None:
    _trunc_normal_fan_in_(m.weight, 2.0, generator)
    nn.init.zeros_(m.bias)


class DiffusionEmbedding(nn.Module):
    """Step embedding: a row of the sinusoid table (an integer step) or the
    lerp of two rows (a continuous time t in [0, 1]), then two 512-wide
    SiLU projections.

    Continuous t takes rows floor(t*50) and ceil(t*50) with the weight
    ``t - floor(t*50)``, the reference's own formula (not ``t*50 -
    floor``). Both rows are clamped to the table, as the JAX gather clamps:
    ceil(t*50) is 50 from t = 0.98 on, and the samplers start at t = 1."""

    def __init__(self, max_steps: int):
        super().__init__()
        self.max_steps = max_steps
        self.register_buffer("table", torch.from_numpy(_embedding_table(max_steps)), persistent=False)
        self.projection1 = nn.Linear(128, 512)
        self.projection2 = nn.Linear(512, 512)

    def reset_parameters(self, generator=None) -> None:
        _init_linear(self.projection1, generator)
        _init_linear(self.projection2, generator)

    def forward(self, t: Tensor) -> Tensor:
        top = self.max_steps - 1
        if not t.is_floating_point():
            x = self.table[t.long().clamp(max=top)]
        else:
            low_idx = torch.floor(t * 50)
            high_idx = torch.ceil(t * 50)
            low = self.table[low_idx.long().clamp(0, top)]
            high = self.table[high_idx.long().clamp(0, top)]
            x = low + (high - low) * (t - low_idx)[:, None]
        x = F.silu(self.projection1(x))
        return F.silu(self.projection2(x))


class ResidualBlock(nn.Module):
    """Gated dilated conv block: (x + step projection) through a dilated
    conv, plus the conditioner's dilated conv, split into gate and filter,
    sigmoid(gate) * tanh(filter), then a residual and a skip 1x1 conv."""

    def __init__(self, residual_channels: int, dilation: int):
        super().__init__()
        c = residual_channels
        self.dilated_conv = nn.Conv1d(c, 2 * c, 3, padding=dilation, dilation=dilation)
        self.dilated_cond_conv = nn.Conv1d(c, 2 * c, 3, padding=dilation, dilation=dilation)
        self.diffusion_projection = nn.Linear(512, c)
        self.output_residual = nn.Conv1d(c, c, 1)
        self.output_projection = nn.Conv1d(c, c, 1)

    def reset_parameters(self, generator=None) -> None:
        for conv in (self.dilated_conv, self.dilated_cond_conv, self.output_residual, self.output_projection):
            _init_conv(conv, generator)
        _init_linear(self.diffusion_projection, generator)

    def forward(self, x: Tensor, diffusion_step: Tensor, conditioner: Tensor):
        y = x + self.diffusion_projection(diffusion_step)[:, :, None]
        y = self.dilated_conv(y) + self.dilated_cond_conv(conditioner)
        gate, filt = torch.chunk(y, 2, dim=1)
        y = torch.sigmoid(gate) * torch.tanh(filt)
        return (x + self.output_residual(y)) / math.sqrt(2.0), self.output_projection(y)


class DiffuSE(nn.Module):
    """Time-domain diffusion backbone.

    forward(x (batch, chan_in, time) diffused state, diffusion_step (batch,)
    float times or integer steps, y (batch, 1, time) conditioner) ->
    (batch, chan_out, time)."""

    def __init__(self, num_channels_in: int, num_channels_out: int, residual_layers: int = 30,
                 residual_channels: int = 64, dilation_cycle_length: int = 10, embedding_len: int = 50):
        super().__init__()
        c = residual_channels
        self.input_projection = nn.Conv1d(num_channels_in, c, 1)
        self.condition_projection = nn.Conv1d(1, c, 1)
        self.diffusion_embedding = DiffusionEmbedding(embedding_len)
        self.residual_layers = nn.ModuleList(
            ResidualBlock(c, 2 ** (i % dilation_cycle_length)) for i in range(residual_layers))
        self.skip_projection = nn.Conv1d(c, c, 1)
        self.output_projection = nn.Conv1d(c, num_channels_out, 1)

    def reset_parameters(self, generator=None) -> None:
        """Seeded init with the JAX package's initializers: he_normal convs,
        lecun_normal dense layers, zero biases, a zero output projection."""
        _init_conv(self.input_projection, generator)
        _init_conv(self.condition_projection, generator)
        self.diffusion_embedding.reset_parameters(generator)
        for layer in self.residual_layers:
            layer.reset_parameters(generator)
        _init_conv(self.skip_projection, generator)
        nn.init.zeros_(self.output_projection.weight)
        nn.init.zeros_(self.output_projection.bias)

    def forward(self, x: Tensor, diffusion_step: Tensor, y: Tensor) -> Tensor:
        x = F.relu(self.input_projection(x))
        conditioner = self.condition_projection(y)
        emb = self.diffusion_embedding(diffusion_step)
        # the skips summed as they come, in the order of the JAX package's
        # sum(skips): one running sum is alive instead of every layer's skip
        skips = 0
        for layer in self.residual_layers:
            x, skip = layer(x, emb, conditioner)
            skips = skips + skip
        x = skips / math.sqrt(len(self.residual_layers))
        x = F.relu(self.skip_projection(x))
        return self.output_projection(x)
