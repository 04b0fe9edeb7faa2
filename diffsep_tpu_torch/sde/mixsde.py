"""The diffusion-mixing SDE for source separation.

Counterpart of ``MixSDE`` in ``diffsep_tpu/sde/mixsde.py``:

    dx = -lambda Pn x dt + sigma(t) sqrt(2 log(sigma_max/sigma_min)) dw
    sigma(t) = sigma_min (sigma_max / sigma_min)^t

with A = 11^T/n the averaging matrix and Pn = I - A. Both mean and std
operators are a A + b Pn, so inverses and ratios are closed forms. The
variance-proportional time sampler is the JAX package's inverse-CDF table.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .base import SDE

Tensor = torch.Tensor


def mix_mats(ndim: int, dtype=torch.float32, device=None) -> Tuple[Tensor, Tensor]:
    """A = 11^T/n and Pn = I - A, each shaped (1, n, n)."""
    A = torch.full((1, ndim, ndim), 1.0 / ndim, dtype=dtype, device=device)
    Pn = torch.eye(ndim, dtype=dtype, device=device)[None] - A
    return A, Pn


def _col(v: Tensor) -> Tensor:
    return v[:, None, None]


def interp(x: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """``jnp.interp``: piecewise-linear through (xp, fp), xp increasing,
    constant past either end."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    f = f0 + (x - x0) / (x1 - x0) * (f1 - f0)
    return torch.where(x < xp[0], fp[0], torch.where(x > xp[-1], fp[-1], f))


def inv_cdf_times(u: Tensor, t_eps: float, T: float, std_fn, table: int = 1024) -> Tensor:
    """Times in [t_eps, T] with density proportional to std_fn(t), at the
    uniform draws u in [0, 1): the inverse CDF of a ``table``-point grid
    (``_inv_cdf_times``, diffsep_tpu/sde/mixsde.py:46-56)."""
    grid = torch.linspace(t_eps, T, table, dtype=torch.float32, device=u.device)
    cdf = torch.cumsum(std_fn(grid), dim=0)
    cdf = (cdf - cdf[0]) / (cdf[-1] - cdf[0])
    return interp(u, cdf, grid)


@dataclasses.dataclass(frozen=True)
class MixSDE(SDE):
    ndim: int = 2
    d_lambda: float = 2.0
    sigma_min: float = 0.05
    sigma_max: float = 0.5
    N: int = 30

    @property
    def ratiosig(self) -> float:
        return self.sigma_max / self.sigma_min

    @property
    def logsig(self) -> float:
        return math.log(self.ratiosig)

    def sde(self, x: Tensor, t: Tensor, cond: Tensor) -> Tuple[Tensor, Tensor]:
        _, Pn = mix_mats(self.ndim, x.dtype, x.device)
        drift = -self.d_lambda * (Pn @ x)
        sigma = self.sigma_min * self.ratiosig**t
        return drift, sigma * math.sqrt(2.0 * self.logsig)

    def _mean_mix_mat(self, t: Tensor) -> Tensor:
        A, Pn = mix_mats(self.ndim, t.dtype, t.device)
        return A + _col(torch.exp(-t * self.d_lambda)) * Pn

    def _cov_eigval(self, t: Tensor) -> Tuple[Tensor, Tensor]:
        """Covariance eigenvalues along A (ev1) and along Pn (ev2)."""
        mult = self.sigma_min**2
        s_ratio_power = self.ratiosig ** (2.0 * t)
        ev1 = mult * (s_ratio_power - 1.0)
        denom = 1.0 + self.d_lambda / self.logsig
        ev2 = mult * (s_ratio_power - torch.exp(-2.0 * self.d_lambda * t)) / denom
        return ev1, ev2

    def _var(self, t: Tensor) -> Tensor:
        ev1, ev2 = self._cov_eigval(t)
        return 0.5 * (ev1 + ev2)

    def _std(self, t: Tensor) -> Tensor:
        A, Pn = mix_mats(self.ndim, t.dtype, t.device)
        ev1, ev2 = self._cov_eigval(t)
        return _col(torch.sqrt(ev1)) * A + _col(torch.sqrt(ev2)) * Pn

    def marginal_prob(self, x0: Tensor, t: Tensor, cond: Tensor) -> Tuple[Tensor, Tensor]:
        return self._mean_mix_mat(t) @ x0, self._std(t)

    @staticmethod
    def mult_std(L: Tensor, x: Tensor) -> Tensor:
        return L @ x

    def mult_std_inv(self, L: Tensor, x: Tensor) -> Tensor:
        # L = a A + b Pn => L^{-1} = A/a + Pn/b; the row sums of L give a
        # and its trace a + (n-1) b
        n = L.shape[-1]
        a = L.sum(dim=-1).mean(dim=-1)
        b = (torch.diagonal(L, dim1=-2, dim2=-1).sum(-1) - a) / (n - 1)
        A, Pn = mix_mats(n, x.dtype, x.device)
        return (_col(1.0 / a) * A + _col(1.0 / b) * Pn) @ x

    def mean_mat_inv(self, t: Tensor) -> Tensor:
        """(A + e^{-lambda t} Pn)^{-1} = A + e^{lambda t} Pn."""
        A, Pn = mix_mats(self.ndim, t.dtype, t.device)
        return A + _col(torch.exp(t * self.d_lambda)) * Pn

    def apply_mean_inv(self, t: Tensor, x: Tensor) -> Tensor:
        return self.mean_mat_inv(t) @ x

    def apply_mean(self, t: Tensor, x: Tensor) -> Tensor:
        return self._mean_mix_mat(t) @ x

    def std_ratio(self, t_next: Tensor, t: Tensor) -> Tensor:
        """L(t_next) L(t)^{-1} = A sqrt(ev1'/ev1) + Pn sqrt(ev2'/ev2)."""
        A, Pn = mix_mats(self.ndim, t.dtype, t.device)
        ev1, ev2 = self._cov_eigval(t)
        ev1n, ev2n = self._cov_eigval(t_next)
        return _col(torch.sqrt(ev1n / ev1)) * A + _col(torch.sqrt(ev2n / ev2)) * Pn

    def apply_std_ratio(self, t_next: Tensor, t: Tensor, x: Tensor) -> Tensor:
        return self.std_ratio(t_next, t) @ x

    def prior_sampling(
        self, cond: Tensor, generator: Optional[torch.Generator] = None,
        z: Optional[Tensor] = None,
    ) -> Tensor:
        """x_T = mix/ndim on every source + L(T) z. `z` (batch, ndim,
        n_samples) may be given; otherwise it is drawn from `generator`."""
        b, _, n_samples = cond.shape
        t = torch.full((b,), self.T, dtype=cond.dtype, device=cond.device)
        mean = (cond / self.ndim).expand(b, self.ndim, n_samples)
        if z is None:
            z = torch.randn(
                mean.shape, generator=generator, dtype=mean.dtype,
                device=mean.device,
            )
        return mean + self._std(t) @ z

    def sample_time_varprop(self, u: Tensor, t_eps: float = 0.0) -> Tensor:
        """Times with density proportional to the marginal std, at the
        uniform draws u (one per time)."""
        return inv_cdf_times(u, t_eps, self.T, lambda t: torch.sqrt(self._var(t)))
