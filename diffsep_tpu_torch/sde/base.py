"""SDE base class and the reverse-time SDE.

Counterpart of ``diffsep_tpu/sde/base.py``. Shapes (time domain): the state
x is (batch, n_src, n_samples), t is (batch,), the conditioning mixture is
(batch, 1, n_samples). ``marginal_prob`` returns (mean, L) with L a matrix
square root of the covariance that ``mult_std``/``mult_std_inv`` apply.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

Tensor = torch.Tensor
ScoreFn = Callable[[Tensor, Tensor, Tensor], Tensor]  # score_fn(x, t, cond)


def _square_bcast(g: Tensor, x: Tensor) -> Tensor:
    """g**2 with trailing singleton dims so it broadcasts over x."""
    g = torch.as_tensor(g, device=x.device)
    return (g**2).reshape(tuple(g.shape) + (1,) * (x.ndim - g.ndim))


@dataclasses.dataclass(frozen=True)
class SDE:
    """Forward SDE dx = f(x, t) dt + g(t) dw."""

    N: int = 1000

    @property
    def T(self) -> float:
        return 1.0

    def sde(self, x: Tensor, t: Tensor, cond: Tensor) -> Tuple[Tensor, Tensor]:
        raise NotImplementedError

    def marginal_prob(self, x0: Tensor, t: Tensor, cond: Tensor) -> Tuple[Tensor, Any]:
        raise NotImplementedError

    def prior_sampling(
        self, cond: Tensor, generator: Optional[torch.Generator] = None,
        z: Optional[Tensor] = None,
    ) -> Tensor:
        raise NotImplementedError

    @staticmethod
    def mult_std(L: Tensor, x: Tensor) -> Tensor:
        raise NotImplementedError

    def mult_std_inv(self, L: Tensor, x: Tensor) -> Tensor:
        raise NotImplementedError

    def discretize(
        self, x: Tensor, t: Tensor, cond: Tensor, dt: Optional[float] = None
    ) -> Tuple[Tensor, Tensor]:
        """Euler-Maruyama step: x_{i+1} = x_i + f dt + g sqrt(dt) z."""
        if dt is None:
            dt = 1.0 / self.N
        drift, diffusion = self.sde(x, t, cond)
        return drift * dt, diffusion * math.sqrt(float(dt))

    def copy(self, **updates) -> "SDE":
        return dataclasses.replace(self, **updates)


def reverse_sde(
    sde: SDE, score_fn: ScoreFn, x: Tensor, t: Tensor, cond: Tensor,
    probability_flow: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Drift f - g^2 score (halved for the probability-flow ODE) and
    diffusion g (0 for the ODE) of the reverse-time SDE."""
    drift, diffusion = sde.sde(x, t, cond)
    score = score_fn(x, t, cond)
    score_drift = -_square_bcast(diffusion, x) * score * (
        0.5 if probability_flow else 1.0
    )
    rev_diffusion = torch.zeros_like(diffusion) if probability_flow else diffusion
    return drift + score_drift, rev_diffusion


def reverse_discretize(
    sde: SDE, score_fn: ScoreFn, x: Tensor, t: Tensor, cond: Tensor,
    dt: Optional[float] = None, probability_flow: bool = False,
    score: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Discretized reverse step: returns (rev_f, rev_G) with
    x_mean = x - rev_f and x = x_mean + rev_G z."""
    f, G = sde.discretize(x, t, cond, dt=dt)
    if score is None:
        score = score_fn(x, t, cond)
    rev_f = f - _square_bcast(G, x) * score * (0.5 if probability_flow else 1.0)
    rev_G = torch.zeros_like(G) if probability_flow else G
    return rev_f, rev_G
