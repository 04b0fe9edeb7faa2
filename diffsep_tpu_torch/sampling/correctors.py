"""Langevin correctors.

Counterpart of ``diffsep_tpu/sampling/correctors.py``: ``langevin``
(SNR-scaled step from the score and noise norms), ``ald`` (annealed, with
the first source's std as a scalar; MixSDE), ``ald2`` (matrix std, the
production corrector; MixSDE and PriorMixSDE) and ``none``. ``update`` takes one standard-normal draw per
corrector step from the caller; each step evaluates the score once.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..sde.base import SDE
from ..sde.mixsde import MixSDE, PriorMixSDE

Tensor = torch.Tensor


class Corrector:
    def __init__(self, sde: SDE, score_fn: Callable, snr: float, n_steps: int):
        self.sde = sde
        self.score_fn = score_fn
        self.snr = snr
        self.n_steps = n_steps

    def update(self, x, t, cond, noise: Sequence[Tensor]):
        raise NotImplementedError


def _require_sde(sde, name: str, classes) -> None:
    if not isinstance(sde, classes):
        raise NotImplementedError(f"SDE class {type(sde).__name__} not supported by {name!r}")


class LangevinCorrector(Corrector):
    """Step size 2 (snr |z| / |score|)^2, the norms per sample averaged over
    the batch."""

    def update(self, x, t, cond, noise):
        x_mean = x
        for i in range(self.n_steps):
            grad = self.score_fn(x, t, cond)
            grad_norm = torch.linalg.vector_norm(grad.reshape(grad.shape[0], -1), dim=-1).mean()
            noise_norm = torch.linalg.vector_norm(noise[i].reshape(noise[i].shape[0], -1), dim=-1).mean()
            step_size = (self.snr * noise_norm / grad_norm) ** 2 * 2
            x_mean = x + step_size * grad
            x = x_mean + noise[i] * torch.sqrt(step_size * 2)
        return x, x_mean


class AnnealedLangevinDynamics(Corrector):
    """Annealed Langevin with the std scalarized as the first source's."""

    def __init__(self, sde, score_fn, snr, n_steps):
        _require_sde(sde, "ald", MixSDE)
        super().__init__(sde, score_fn, snr, n_steps)

    def update(self, x, t, cond, noise):
        x_mean = x
        L = self.sde.marginal_prob(x, t, cond)[1]
        std = torch.sqrt((L @ L)[:, 0, :].sum(dim=-1, keepdim=True))
        step_size = (self.snr * std.reshape(tuple(std.shape) + (1,) * (x.ndim - std.ndim))) ** 2 * 2
        for i in range(self.n_steps):
            x_mean = x + step_size * self.score_fn(x, t, cond)
            x = x_mean + noise[i] * torch.sqrt(step_size * 2)
        return x, x_mean


class AnnealedLangevinDynamics2(Corrector):
    """Matrix-std annealed Langevin: step = 2 snr^2 L L score, noise =
    2 snr L z."""

    def __init__(self, sde, score_fn, snr, n_steps):
        _require_sde(sde, "ald2", (MixSDE, PriorMixSDE))
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
    "langevin": LangevinCorrector,
    "ald": AnnealedLangevinDynamics,
    "ald2": AnnealedLangevinDynamics2,
    "none": NoneCorrector,
}
