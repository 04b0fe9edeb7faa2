"""Normalizations of the NCSN v1/v2 lineage, on NHWC activations.

Counterpart of ``diffsep_tpu/models/normalization.py``: InstanceNorm++,
the conditional instance, variance, batch and "none" norms, their
unconditional forms, and ``get_normalization``. They back the legacy blocks
of ``legacy_layers.py``; NCSN++ uses GroupNorm.

Inputs are (batch, H, W, C); a conditional norm also takes integer class
labels y (batch,), looked up in an ``nn.Embedding``. The semantics are the
JAX package's, which its tests pinned to the reference:

- the variance norms divide by the unbiased variance over (H, W), as
  ``torch.var`` defaults to;
- InstanceNorm++ adds back the per-channel means, standardized across the
  channels with their unbiased variance, times alpha;
- ``ConditionalBatchNorm2d`` is ``nn.BatchNorm2d(affine=False)``: in train
  mode it normalizes with the biased batch variance and keeps the unbiased
  one in ``running_var`` (momentum 0.1); in eval mode it normalizes with
  the running statistics.

Each norm with parameters draws them in ``reset_parameters(generator)``
(``legacy_layers.reset_parameters`` draws a whole block). Parameters follow
the reference's torch layout: ``alpha`` and ``gamma`` of
InstanceNorm++ and ``alpha`` of VarianceNorm2d are the factors themselves
(the JAX package stores their offsets from 1), an embedding is
``embed.weight``, the batch norm's statistics ``bn.running_mean`` and
``bn.running_var``. ``convert.legacy_state_dict_from_jax`` maps a JAX tree
onto them.
"""
from __future__ import annotations

import functools
from typing import Mapping, Optional

import torch
from torch import nn

from .layers import GroupNorm

Tensor = torch.Tensor


def _instance_norm(x: Tensor, eps: float = 1e-5) -> Tensor:
    """Affine-free instance norm over (H, W), biased variance."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps)


def _standardized_means(x: Tensor) -> Tensor:
    """The per-channel means of x (b, c), standardized across the channels
    with their unbiased variance."""
    means = x.mean(dim=(1, 2))
    m = means.mean(dim=-1, keepdim=True)
    v = means.var(dim=-1, keepdim=True, unbiased=True)
    return (means - m) / torch.sqrt(v + 1e-5)


class LearnedNorm(nn.Module):
    """A norm with learned parameters, drawn by ``reset_parameters(generator)``
    (from the global generator at construction)."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        raise NotImplementedError


def _near_one_(w: Tensor, generator) -> None:
    w.normal_(1.0, 0.02, generator=generator)


def _scale_bias_(w: Tensor, n: int, generator) -> None:
    """Scale columns uniform in [0, 1), bias columns (past n) zero."""
    w[:, :n].uniform_(generator=generator)
    w[:, n:].zero_()


def _bc(v: Tensor) -> Tensor:
    """(b, c) -> (b, 1, 1, c)."""
    return v[:, None, None, :]


class InstanceNorm2dPlus(LearnedNorm):
    """InstanceNorm++: instance norm plus the standardized channel means
    times alpha, then gamma (and beta)."""

    def __init__(self, num_features: int, bias: bool = True):
        super().__init__()
        self.bias = bias
        self.alpha = nn.Parameter(torch.empty(num_features))
        self.gamma = nn.Parameter(torch.empty(num_features))
        if bias:
            self.beta = nn.Parameter(torch.empty(num_features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            _near_one_(self.alpha, generator)
            _near_one_(self.gamma, generator)
            if self.bias:
                self.beta.zero_()

    def forward(self, x: Tensor) -> Tensor:
        h = _instance_norm(x) + _bc(_standardized_means(x)) * self.alpha
        out = self.gamma * h
        return out + self.beta if self.bias else out


class ConditionalInstanceNorm2dPlus(LearnedNorm):
    """Class-conditional InstanceNorm++: gamma, alpha (and beta) are rows of
    one embedding, laid out [gamma | alpha | beta]."""

    def __init__(self, num_features: int, num_classes: int, bias: bool = True):
        super().__init__()
        self.num_features = num_features
        self.bias = bias
        self.embed = nn.Embedding(num_classes, (3 if bias else 2) * num_features)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        n = self.num_features
        with torch.no_grad():
            _near_one_(self.embed.weight[:, :2 * n], generator)
            self.embed.weight[:, 2 * n:].zero_()

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        parts = self.embed(y).chunk(3 if self.bias else 2, dim=-1)
        gamma, alpha = parts[0], parts[1]
        h = _instance_norm(x) + _bc(_standardized_means(x)) * _bc(alpha)
        out = _bc(gamma) * h
        return out + _bc(parts[2]) if self.bias else out


class VarianceNorm2d(LearnedNorm):
    """Scale-only normalization: alpha x / sqrt(unbiased var + eps)."""

    def __init__(self, num_features: int, bias: bool = False):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(num_features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            _near_one_(self.alpha, generator)

    def forward(self, x: Tensor) -> Tensor:
        var = x.var(dim=(1, 2), keepdim=True, unbiased=True)
        return self.alpha * x / torch.sqrt(var + 1e-5)


class ConditionalVarianceNorm2d(LearnedNorm):
    """VarianceNorm2d with a per-class gamma."""

    def __init__(self, num_features: int, num_classes: int, bias: bool = False):
        super().__init__()
        self.embed = nn.Embedding(num_classes, num_features)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            _near_one_(self.embed.weight, generator)

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        var = x.var(dim=(1, 2), keepdim=True, unbiased=True)
        return _bc(self.embed(y)) * (x / torch.sqrt(var + 1e-5))


class _ClassAffine(LearnedNorm):
    """A per-class gamma (and beta) from one embedding [gamma | beta], gamma
    drawn uniform in [0, 1) and beta zero, applied after ``normalize``."""

    def __init__(self, num_features: int, num_classes: int, bias: bool = True):
        super().__init__()
        self.num_features = num_features
        self.bias = bias
        self.embed = nn.Embedding(num_classes, (2 if bias else 1) * num_features)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            _scale_bias_(self.embed.weight, self.num_features, generator)

    def normalize(self, x: Tensor) -> Tensor:
        raise NotImplementedError

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        h = self.normalize(x)
        if self.bias:
            gamma, beta = self.embed(y).chunk(2, dim=-1)
            return _bc(gamma) * h + _bc(beta)
        return _bc(self.embed(y)) * h


class ConditionalBatchNorm2d(_ClassAffine):
    """Affine-free ``nn.BatchNorm2d`` (train and eval as torch's, running
    statistics in ``bn``), then a per-class gamma (and beta)."""

    def __init__(self, num_features: int, num_classes: int, bias: bool = True):
        super().__init__(num_features, num_classes, bias)
        self.bn = nn.BatchNorm2d(num_features, affine=False)

    def normalize(self, x: Tensor) -> Tensor:
        return self.bn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConditionalInstanceNorm2d(_ClassAffine):
    """Affine-free instance norm, then a per-class gamma (and beta)."""

    def normalize(self, x: Tensor) -> Tensor:
        return _instance_norm(x)


class InstanceNorm2d(nn.Module):
    """Affine-free instance norm (``nn.InstanceNorm2d``'s default)."""

    def __init__(self, num_features: int = 0, bias: bool = True):
        super().__init__()

    def forward(self, x: Tensor) -> Tensor:
        return _instance_norm(x)


class NoneNorm2d(nn.Module):
    """Identity."""

    def __init__(self, num_features: int = 0, bias: bool = True):
        super().__init__()

    def forward(self, x: Tensor) -> Tensor:
        return x


class ConditionalNoneNorm2d(_ClassAffine):
    """No normalization, only the per-class gamma (and beta)."""

    def normalize(self, x: Tensor) -> Tensor:
        return x


def _node(config, key):
    return config[key] if isinstance(config, Mapping) else getattr(config, key)


def get_normalization(config, conditional: bool = False):
    """The norm factory ``config.model.normalization`` names (a mapping or
    an object with attributes); a conditional one also reads
    ``config.model.num_classes``."""
    model = _node(config, "model")
    norm = _node(model, "normalization")
    if conditional:
        if norm == "InstanceNorm++":
            return functools.partial(ConditionalInstanceNorm2dPlus, num_classes=_node(model, "num_classes"))
        raise NotImplementedError(f"{norm} not implemented yet.")
    if norm == "InstanceNorm":
        return InstanceNorm2d
    if norm == "InstanceNorm++":
        return InstanceNorm2dPlus
    if norm == "VarianceNorm":
        return VarianceNorm2d
    if norm == "GroupNorm":
        return lambda num_features: GroupNorm(num_features, min(max(num_features // 4, 1), 32), eps=1e-6)
    raise ValueError(f"Unknown normalization: {norm}")
