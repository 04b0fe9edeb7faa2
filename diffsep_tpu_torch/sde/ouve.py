"""Ornstein-Uhlenbeck SDEs of the SGMSE lineage for speech enhancement.

Counterpart of ``OUVESDE`` and ``OUVPSDE`` in ``diffsep_tpu/sde/ouve.py``.
No recipe sets them; OUVP is unstable around t = 0.2, as the JAX package
notes. The std is a scalar per batch entry, broadcast over any rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .base import SDE, batch_broadcast

Tensor = torch.Tensor


def _draw(cond: Tensor, generator, z: Optional[Tensor]) -> Tensor:
    if z is None:
        z = torch.randn(cond.shape, generator=generator, dtype=cond.dtype, device=cond.device)
    return z


@dataclasses.dataclass(frozen=True)
class OUVESDE(SDE):
    """OU variance-exploding SDE: dx = theta (y - x) dt + sigma(t) dw."""

    theta: float = 1.5
    sigma_min: float = 0.05
    sigma_max: float = 0.5
    N: int = 1000

    @property
    def logsig(self) -> float:
        return math.log(self.sigma_max / self.sigma_min)

    def sde(self, x: Tensor, t: Tensor, cond: Tensor) -> Tuple[Tensor, Tensor]:
        sigma = self.sigma_min * (self.sigma_max / self.sigma_min) ** t
        return self.theta * (cond - x), sigma * math.sqrt(2.0 * self.logsig)

    def _mean(self, x0: Tensor, t: Tensor, y: Tensor) -> Tensor:
        e = batch_broadcast(torch.exp(-self.theta * t), x0)
        return e * x0 + (1.0 - e) * y

    def _std(self, t: Tensor) -> Tensor:
        s, th, lg = self.sigma_min, self.theta, self.logsig
        return torch.sqrt(
            (s**2 * torch.exp(-2 * th * t) * (torch.exp(2 * (th + lg) * t) - 1) * lg) / (th + lg))

    def marginal_prob(self, x0: Tensor, t: Tensor, cond: Tensor) -> Tuple[Tensor, Tensor]:
        return self._mean(x0, t, cond), self._std(t)

    def prior_sampling(self, cond: Tensor, generator: Optional[torch.Generator] = None,
                       z: Optional[Tensor] = None) -> Tensor:
        """x_T = y + std(1) z; `z` of y's shape may be given."""
        std = self._std(torch.ones((cond.shape[0],), dtype=cond.dtype, device=cond.device))
        return cond + batch_broadcast(std, cond) * _draw(cond, generator, z)


@dataclasses.dataclass(frozen=True)
class OUVPSDE(SDE):
    """OU variance-preserving SDE, dx = 1/2 beta(t) stiffness (y - x) dt +
    sqrt(beta(t)) dw, beta(t) = beta_min + t (beta_max - beta_min)."""

    beta_min: float = 0.01
    beta_max: float = 1.0
    stiffness: float = 1.0
    N: int = 1000

    def _beta(self, t: Tensor) -> Tensor:
        return self.beta_min + t * (self.beta_max - self.beta_min)

    def sde(self, x: Tensor, t: Tensor, cond: Tensor) -> Tuple[Tensor, Tensor]:
        drift = 0.5 * self.stiffness * batch_broadcast(self._beta(t), x) * (cond - x)
        return drift, torch.sqrt(self._beta(t))

    def _exponent(self, t: Tensor) -> Tensor:
        b0, b1 = self.beta_min, self.beta_max
        return self.stiffness * t * (t * (b1 - b0) + 2 * b0)

    def _mean(self, x0: Tensor, t: Tensor, y: Tensor) -> Tensor:
        return y + batch_broadcast(torch.exp(-0.25 * self._exponent(t)), x0) * (x0 - y)

    def _std(self, t: Tensor) -> Tensor:
        return (1.0 - torch.exp(-0.5 * self._exponent(t))) / self.stiffness

    def marginal_prob(self, x0: Tensor, t: Tensor, cond: Tensor) -> Tuple[Tensor, Tensor]:
        return self._mean(x0, t, cond), self._std(t)

    def prior_sampling(self, cond: Tensor, generator: Optional[torch.Generator] = None,
                       z: Optional[Tensor] = None) -> Tensor:
        """x_T = y + std(1) z; `z` of y's shape may be given."""
        std = self._std(torch.ones((cond.shape[0],), dtype=cond.dtype, device=cond.device))
        return cond + batch_broadcast(std, cond) * _draw(cond, generator, z)
