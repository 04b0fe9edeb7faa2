"""Predictor-corrector sampling.

Counterpart of ``make_timesteps`` and ``pc_sample`` in
``diffsep_tpu/sampling/pc.py``. The JAX version runs the steps as one
``lax.scan``; here it is a Python loop over steps, each step a corrector
update then a predictor update.

Randomness: every standard-normal draw comes from `generator`, unless the
caller passes it in `noise` (how the tests hand both packages the same
draws):
  noise["prior"]      (batch, n_src, n_samples)
  noise["corrector"]  (N, corrector_steps, batch, n_src, n_samples)
  noise["predictor"]  (N, batch, n_src, n_samples)
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..sde.base import SDE
from .correctors import CORRECTORS
from .predictors import PREDICTORS

Tensor = torch.Tensor


def make_timesteps(
    sde_T: float, eps: float, N: int, schedule: Optional[str]
) -> Tuple[np.ndarray, np.ndarray]:
    """(timesteps[i], dt[i]) of the reverse loop, float32.

    schedule=None: linspace(T, eps, N) with the SDE's own dt = 1/N. A named
    schedule takes N + 1 grid points and dt[i] = |t_i - t_{i+1}|.
    """
    if schedule is None:
        ts = np.linspace(sde_T, eps, N, dtype=np.float32)
        return ts, np.full((N,), 1.0 / N, np.float32)
    if schedule == "linear":
        grid = np.linspace(sde_T, eps, N + 1)
    elif schedule == "log":
        grid = np.logspace(math.log10(sde_T), math.log10(eps), N + 1)
    elif schedule == "revlog":
        grid = np.logspace(math.log10(eps), math.log10(sde_T), N + 1)[::-1]
    else:
        raise NotImplementedError(f"Schedule '{schedule}' does not exist")
    grid = grid.astype(np.float32)
    return grid[:-1], np.abs(grid[:-1] - grid[1:])


def pc_sample(
    sde: SDE,
    score_fn: Callable,
    y: Tensor,
    predictor_name: str = "reverse_diffusion",
    corrector_name: str = "ald2",
    N: Optional[int] = None,
    eps: float = 3e-2,
    snr: float = 0.1,
    corrector_steps: int = 1,
    schedule: Optional[str] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Dict[str, Tensor]] = None,
):
    """Run the reverse process conditioned on the mixture y (batch, 1,
    n_samples). Returns (x, nfe): the last step's denoised mean (JAX
    denoise=True, the only setting the recipes use) and the number of score
    evaluations."""
    if N is not None and N != sde.N:
        sde = sde.copy(N=N)
    predictor = PREDICTORS[predictor_name](sde, score_fn)
    corrector = CORRECTORS[corrector_name](sde, score_fn, snr=snr, n_steps=corrector_steps)
    noise = noise or {}

    def draw(kind: str, *index) -> Tensor:
        if kind in noise:
            return noise[kind][index].to(device=y.device, dtype=y.dtype)
        return torch.randn(
            (y.shape[0], sde.ndim, y.shape[-1]), generator=generator,
            dtype=y.dtype, device=y.device,
        )

    x = sde.prior_sampling(y, z=draw("prior"))
    x_mean = x
    ts, dts = make_timesteps(sde.T, eps, sde.N, schedule)
    ts_next = np.concatenate([ts[1:], ts[-1:]])
    b = y.shape[0]
    for i in range(sde.N):
        t = torch.full((b,), float(ts[i]), dtype=y.dtype, device=y.device)
        t_next = torch.full((b,), float(ts_next[i]), dtype=y.dtype, device=y.device)
        x, x_mean = corrector.update(
            x, t, y, [draw("corrector", i, j) for j in range(corrector.n_steps)]
        )
        z = draw("predictor", i) if predictor.needs_noise else None
        x, x_mean = predictor.update(
            x, t, y, dt=None if schedule is None else float(dts[i]), t_next=t_next, z=z,
        )
    return x_mean, sde.N * (corrector.n_steps + 1)
