"""Reverse-SDE predictors.

Counterpart of ``diffsep_tpu/sampling/predictors.py`` for the predictors of
the separation path: ``reverse_diffusion`` (production) and ``ddim`` (fast
serving). ``update`` returns (x, x_mean); a stochastic predictor takes its
standard-normal draw `z` from the caller.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..sde.base import SDE, reverse_discretize

Tensor = torch.Tensor


def _pad_like(g: Tensor, x: Tensor) -> Tensor:
    return g.reshape(tuple(g.shape) + (1,) * (x.ndim - g.ndim))


class Predictor:
    """One reverse-time step. `t_next` is the next grid time, used by
    integrators that step between exact marginals."""

    needs_noise = False

    def __init__(self, sde: SDE, score_fn: Callable):
        self.sde = sde
        self.score_fn = score_fn

    def update(self, x, t, cond, dt=None, t_next=None, z: Optional[Tensor] = None):
        raise NotImplementedError


class ReverseDiffusionPredictor(Predictor):
    needs_noise = True

    def update(self, x, t, cond, dt=None, t_next=None, z=None):
        rev_f, rev_g = reverse_discretize(self.sde, self.score_fn, x, t, cond, dt=dt)
        x_mean = x - rev_f
        return x_mean + _pad_like(rev_g, x) * z, x_mean


def data_prediction(sde, score_fn, x, t, cond):
    """x0_hat = M(t)^{-1} (x + Sigma(t) score), the DDIM data prediction."""
    score = score_fn(x, t, cond)
    L = sde.marginal_prob(x, t, cond)[1]
    return sde.apply_mean_inv(t, x + sde.mult_std(L, sde.mult_std(L, score)))


def ddim_transition(sde, x, t, t_next, x0_hat):
    """Exact marginal-to-marginal transport given a data prediction:
    x_{t'} = M(t') x0_hat + L(t') L(t)^{-1} (x - M(t) x0_hat)."""
    resid = x - sde.apply_mean(t, x0_hat)
    return sde.apply_mean(t_next, x0_hat) + sde.apply_std_ratio(t_next, t, resid)


class DDIMPredictor(Predictor):
    """Deterministic exact-Gaussian-transition step; the denoised output
    (x_mean) is the data prediction itself."""

    def update(self, x, t, cond, dt=None, t_next=None, z=None):
        if t_next is None:
            raise ValueError("ddim predictor needs grid times (t_next)")
        x0_hat = data_prediction(self.sde, self.score_fn, x, t, cond)
        return ddim_transition(self.sde, x, t, t_next, x0_hat), x0_hat


PREDICTORS = {
    "reverse_diffusion": ReverseDiffusionPredictor,
    "ddim": DDIMPredictor,
}
