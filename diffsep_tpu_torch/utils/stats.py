"""Running mean and standard deviation over batches.

Counterpart of ``diffsep_tpu/utils/stats.py``: ``StandardScaler`` keeps its
statistics in an explicit ``ScalerState`` (count, mean, sum of squared
deviations) that each ``update`` returns anew, combined batch by batch with
Chan et al.'s parallel formula. The tensors live on the batches' device.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

Tensor = torch.Tensor


class ScalerState(NamedTuple):
    count: Tensor  # scalar
    mean: Tensor
    m2: Tensor  # sum of squared deviations


class StandardScaler:
    """Accumulate the mean and std over ``dims`` (default: every axis
    before the feature axes) and scale inputs by them."""

    def __init__(self, feature_shape: Sequence[int], dims=None, eps: float = 1e-7):
        self.feature_shape = tuple(feature_shape)
        self.dims = dims
        self.eps = eps

    def init(self, device: Optional[torch.device] = None) -> ScalerState:
        z = torch.zeros(self.feature_shape, dtype=torch.float32, device=device)
        return ScalerState(count=torch.zeros((), dtype=torch.float32, device=device), mean=z, m2=z.clone())

    def update(self, state: ScalerState, x: Tensor) -> ScalerState:
        dims = self.dims
        if dims is None:
            dims = tuple(range(x.ndim - len(self.feature_shape)))
        dims = tuple(dims)
        n_b = float(math.prod(x.shape[d] for d in dims))
        mean_b = x.mean(dim=dims)
        m2_b = (x - x.mean(dim=dims, keepdim=True)).square().sum(dim=dims)
        n = state.count + n_b
        frac = n_b / torch.clamp(n, min=1.0)
        delta = mean_b - state.mean
        mean = state.mean + delta * frac
        m2 = state.m2 + m2_b + delta.square() * state.count * frac
        return ScalerState(count=n, mean=mean, m2=m2)

    def std(self, state: ScalerState) -> Tensor:
        var = state.m2 / torch.clamp(state.count - 1.0, min=1.0)
        return torch.sqrt(torch.clamp(var, min=0.0)) + self.eps

    def scale(self, state: ScalerState, x: Tensor) -> Tensor:
        return (x - state.mean) / self.std(state)

    def unscale(self, state: ScalerState, x: Tensor) -> Tensor:
        return x * self.std(state) + state.mean
