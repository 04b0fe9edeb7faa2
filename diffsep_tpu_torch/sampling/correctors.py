"""Langevin correctors.

Counterpart of ``diffsep_tpu/sampling/correctors.py`` for the correctors of
the separation path: ``ald2`` (production) and ``none``. ``update`` takes
one standard-normal draw per corrector step from the caller.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..sde.base import SDE
from ..sde.mixsde import MixSDE

Tensor = torch.Tensor


class Corrector:
    def __init__(self, sde: SDE, score_fn: Callable, snr: float, n_steps: int):
        self.sde = sde
        self.score_fn = score_fn
        self.snr = snr
        self.n_steps = n_steps

    def update(self, x, t, cond, noise: Sequence[Tensor]):
        raise NotImplementedError


class AnnealedLangevinDynamics2(Corrector):
    """Matrix-std annealed Langevin: step = 2 snr^2 L L score, noise =
    2 snr L z."""

    def __init__(self, sde, score_fn, snr, n_steps):
        if not isinstance(sde, MixSDE):
            raise NotImplementedError(f"SDE class {type(sde).__name__} not supported by 'ald2'")
        super().__init__(sde, score_fn, snr, n_steps)

    def update(self, x, t, cond, noise):
        x_mean = x
        L = self.sde.marginal_prob(x, t, cond)[1]
        for i in range(self.n_steps):
            grad = self.sde.mult_std(L, self.sde.mult_std(L, self.score_fn(x, t, cond)))
            x_mean = x + 2.0 * self.snr**2 * grad
            x = x_mean + self.sde.mult_std(2.0 * self.snr * L, noise[i])
        return x, x_mean


class NoneCorrector(Corrector):
    def __init__(self, *args, **kwargs):
        self.snr = 0.0
        self.n_steps = 0

    def update(self, x, t, cond, noise=()):
        return x, x


CORRECTORS = {
    "ald2": AnnealedLangevinDynamics2,
    "none": NoneCorrector,
}
