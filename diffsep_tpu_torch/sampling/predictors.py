"""Reverse-SDE predictors.

Counterpart of ``diffsep_tpu/sampling/predictors.py``: ``reverse_diffusion``
(production), ``euler_maruyama``, ``heun`` (second order on the
probability-flow ODE), ``ddim`` and ``dpmpp`` (exact Gaussian transitions,
the fast serving samplers) and ``none``. ``update`` returns (x, x_mean); a
stochastic predictor takes its standard-normal draw `z` from the caller. A
multistep predictor (``has_state``) also takes and returns its state.
``evals`` is the number of score evaluations of one step.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..sde.base import SDE, reverse_discretize, reverse_sde
from ..sde.mixsde import mix_mats

Tensor = torch.Tensor


def _pad_like(g: Tensor, x: Tensor) -> Tensor:
    return g.reshape(tuple(g.shape) + (1,) * (x.ndim - g.ndim))


class Predictor:
    """One reverse-time step. `t_next` is the next grid time, used by
    integrators that step between exact marginals."""

    needs_noise = False
    has_state = False
    evals = 1

    def __init__(self, sde: SDE, score_fn: Callable, probability_flow: bool = False):
        self.sde = sde
        self.score_fn = score_fn
        self.probability_flow = probability_flow

    def update(self, x, t, cond, dt=None, t_next=None, z: Optional[Tensor] = None):
        raise NotImplementedError


class EulerMaruyamaPredictor(Predictor):
    needs_noise = True

    def update(self, x, t, cond, dt=None, t_next=None, z=None):
        dt = -(1.0 / self.sde.N if dt is None else dt)
        f, g = reverse_sde(self.sde, self.score_fn, x, t, cond, self.probability_flow)
        x_mean = x + f * dt
        return x_mean + _pad_like(g, x) * (-dt) ** 0.5 * z, x_mean


class ReverseDiffusionPredictor(Predictor):
    needs_noise = True

    def update(self, x, t, cond, dt=None, t_next=None, z=None):
        rev_f, rev_g = reverse_discretize(
            self.sde, self.score_fn, x, t, cond, dt=dt, probability_flow=self.probability_flow)
        x_mean = x - rev_f
        if z is None:  # the noise-free step (ode_sample's final denoise)
            return x_mean, x_mean
        return x_mean + _pad_like(rev_g, x) * z, x_mean


class HeunPredictor(Predictor):
    """Second-order Heun step on the probability-flow ODE, deterministic
    (pair with corrector "none"); two score evaluations per step."""

    evals = 2

    def update(self, x, t, cond, dt=None, t_next=None, z=None):
        dt = -(1.0 / self.sde.N if dt is None else dt)

        def drift(x, t):
            return reverse_sde(self.sde, self.score_fn, x, t, cond, probability_flow=True)[0]

        d1 = drift(x, t)
        # the last step would otherwise evaluate below t = 0, where the
        # marginal std is undefined
        d2 = drift(x + d1 * dt, torch.clamp(t + dt, min=1e-4))
        x_next = x + 0.5 * dt * (d1 + d2)
        return x_next, x_next


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


def _lambda_channels(sde, t: Tensor) -> Tuple[Tensor, Tensor]:
    """Log-SNR of each eigenchannel of the mixing SDE, along A and along Pn
    (where the mean's gain is exp(-d_lambda t)). Only differences are
    used."""
    ev1, ev2 = sde._cov_eigval(t)
    return -0.5 * torch.log(ev1), -sde.d_lambda * t - 0.5 * torch.log(ev2)


class DPMpp2MPredictor(Predictor):
    """DPM-Solver++(2M)-style multistep exact-transition step (one score
    evaluation per step, deterministic; pair with corrector "none"). The data
    prediction is extrapolated from the previous step's, D = x0 + c (x0 -
    x0_prev), with c = h / (2 h_prev) in log-SNR time per eigenchannel. The
    first step has no history and is exactly the "ddim" step."""

    has_state = True

    def init_state(self, x: Tensor):
        """(x0_prev, t_prev, history valid); t_prev = 1 keeps the gated-off
        first-step log-SNR finite."""
        return (torch.zeros_like(x), torch.ones((x.shape[0],), dtype=x.dtype, device=x.device),
                torch.zeros((), dtype=x.dtype, device=x.device))

    def update(self, x, t, cond, dt=None, t_next=None, z=None, state=None):
        if t_next is None:
            raise ValueError("dpmpp predictor needs grid times (t_next)")
        sde = self.sde
        x0_hat = data_prediction(sde, self.score_fn, x, t, cond)
        x0_prev, t_prev, valid = state
        lam, lam_next, lam_prev = (_lambda_channels(sde, s) for s in (t, t_next, t_prev))

        def coef(k):
            h, h_prev = lam_next[k] - lam[k], lam[k] - lam_prev[k]
            safe = h_prev.abs() > 1e-12
            c = torch.where(safe, h / torch.where(safe, 2.0 * h_prev, torch.ones_like(h_prev)),
                            torch.zeros_like(h))
            return (valid * c)[:, None, None]

        A, Pn = mix_mats(x.shape[1], x.dtype, x.device)
        D = x0_hat + (coef(0) * A + coef(1) * Pn) @ (x0_hat - x0_prev)
        x_next = sde.apply_mean(t_next, D) + sde.apply_std_ratio(t_next, t, x - sde.apply_mean(t, D))
        return x_next, x0_hat, (x0_hat, t, torch.ones_like(valid))


class NonePredictor(Predictor):
    evals = 0

    def update(self, x, t, cond, dt=None, t_next=None, z=None):
        return x, x


PREDICTORS = {
    "euler_maruyama": EulerMaruyamaPredictor,
    "reverse_diffusion": ReverseDiffusionPredictor,
    "heun": HeunPredictor,
    "ddim": DDIMPredictor,
    "dpmpp": DPMpp2MPredictor,
    "none": NonePredictor,
}
