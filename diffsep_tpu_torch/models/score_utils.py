"""Score-network registry, noise schedules and the score of a raw network.

Counterpart of ``diffsep_tpu/models/score_utils.py``: ``register_model`` /
``get_model`` on the port's ``Registry``, the SMLD sigma ladder
(``get_sigmas``) and the DDPM tables (``get_ddpm_params``), both numpy as
there, and ``get_score_fn``, which turns a network ``model_fn(x, labels)``
into a time-dependent score under the OUVE and OUVP conventions, continuous
or discrete. No recipe reaches it.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..sde.ouve import OUVESDE, OUVPSDE
from ..utils.registry import Registry

ModelRegistry = Registry("score model")


def register_model(cls=None, *, name: str | None = None):
    """Decorator registering a score-network class by name (its own by
    default)."""

    def _register(c):
        ModelRegistry.register(name or c.__name__)(c)
        return c

    return _register if cls is None else _register(cls)


def get_model(name: str):
    return ModelRegistry.get_by_name(name)


def get_sigmas(sigma_min: float, sigma_max: float, num_scales: int) -> np.ndarray:
    """Geometric noise levels from sigma_max down to sigma_min."""
    return np.exp(np.linspace(np.log(sigma_max), np.log(sigma_min), num_scales))


def get_ddpm_params(beta_min: float, beta_max: float, num_scales: int) -> Dict:
    """DDPM's beta and alpha tables over 1000 diffusion steps (float64)."""
    num_diffusion_timesteps = 1000
    beta_start = beta_min / num_scales
    beta_end = beta_max / num_scales
    betas = np.linspace(beta_start, beta_end, num_diffusion_timesteps, dtype=np.float64)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    return {
        "betas": betas,
        "alphas": alphas,
        "alphas_cumprod": alphas_cumprod,
        "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod),
        "sqrt_1m_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod),
        "beta_min": beta_start * (num_diffusion_timesteps - 1),
        "beta_max": beta_end * (num_diffusion_timesteps - 1),
        "num_diffusion_timesteps": num_diffusion_timesteps,
    }


def get_score_fn(sde, model_fn: Callable, continuous: bool = False) -> Callable:
    """``score_fn(x, t, *cond)`` of the network ``model_fn(x, labels)``:
    under OUVP the network's output divided by -std(t) (the marginal's, or
    the DDPM table's at the discrete step); under OUVE the network's output
    at the label std(t), or the discrete step of t. Other SDEs raise."""
    if isinstance(sde, OUVPSDE):

        def score_fn(x, t, *cond):
            if continuous:
                labels = t * 999
                score = model_fn(x, labels)
                std = sde.marginal_prob(torch.zeros_like(x), t, *cond)[1]
            else:
                labels = t * (sde.N - 1)
                score = model_fn(x, labels)
                table = get_ddpm_params(sde.beta_min, sde.beta_max, sde.N)["sqrt_1m_alphas_cumprod"]
                table = torch.as_tensor(table, dtype=torch.float32, device=x.device)
                std = table[labels.to(torch.int32).long()]
            return -score / std[(...,) + (None,) * (x.ndim - 1)]

        return score_fn

    if isinstance(sde, OUVESDE):

        def score_fn(x, t, *cond):
            if continuous:
                labels = sde.marginal_prob(torch.zeros_like(x), t, *cond)[1]
            else:
                labels = torch.round((sde.T - t) * (sde.N - 1))
            return model_fn(x, labels)

        return score_fn

    raise NotImplementedError(f"SDE class {type(sde).__name__} not yet supported.")
