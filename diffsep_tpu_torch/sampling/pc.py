"""Predictor-corrector sampling and the probability-flow ODE sampler.

Counterpart of ``make_timesteps``, ``pc_sample``, ``get_pc_sampler`` and
``ode_sample`` in ``diffsep_tpu/sampling/pc.py``. The JAX version runs the
steps as one ``lax.scan``; here it is a Python loop over steps, each step a
corrector update then a predictor update. A multistep predictor ("dpmpp")
carries its state from step to step.

Randomness: every standard-normal draw comes from `generator`, unless the
caller passes it in `noise` (how the tests hand both packages the same
draws):
  noise["prior"]      (batch, n_src, n_samples)
  noise["corrector"]  (N, corrector_steps, batch, n_src, n_samples)
  noise["predictor"]  (N, batch, n_src, n_samples)

The number of score evaluations returned (nfe) counts the calls made: the
JAX package counts one per predictor step whatever the predictor, and
leaves out ``ode_sample``'s final denoise step.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..sde.base import SDE, reverse_sde
from .correctors import CORRECTORS
from .predictors import PREDICTORS, ReverseDiffusionPredictor

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
    denoise: bool = True,
    eps: float = 3e-2,
    snr: float = 0.1,
    corrector_steps: int = 1,
    probability_flow: bool = False,
    intermediate: bool = False,
    schedule: Optional[str] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Dict[str, Tensor]] = None,
):
    """Run the reverse process conditioned on the mixture y (batch, 1,
    n_samples). Returns (x, nfe), or (x, nfe, intermediates) with the
    (x, x_mean) pair of every step stacked as (N, 2, batch, n_src,
    n_samples). x is the last step's mean where `denoise`, else its
    sample."""
    if N is not None and N != sde.N:
        sde = sde.copy(N=N)
    predictor = PREDICTORS[predictor_name](sde, score_fn, probability_flow=probability_flow)
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
    state = predictor.init_state(x) if predictor.has_state else None
    ts, dts = make_timesteps(sde.T, eps, sde.N, schedule)
    ts_next = np.concatenate([ts[1:], ts[-1:]])
    b = y.shape[0]
    steps = []
    for i in range(sde.N):
        t = torch.full((b,), float(ts[i]), dtype=y.dtype, device=y.device)
        t_next = torch.full((b,), float(ts_next[i]), dtype=y.dtype, device=y.device)
        x, x_mean = corrector.update(
            x, t, y, [draw("corrector", i, j) for j in range(corrector.n_steps)]
        )
        kw = dict(dt=None if schedule is None else float(dts[i]), t_next=t_next,
                  z=draw("predictor", i) if predictor.needs_noise else None)
        if state is not None:
            x, x_mean, state = predictor.update(x, t, y, state=state, **kw)
        else:
            x, x_mean = predictor.update(x, t, y, **kw)
        if intermediate:
            steps.append(torch.stack([x, x_mean]))
    nfe = sde.N * (corrector.n_steps + predictor.evals)
    result = x_mean if denoise else x
    if intermediate:
        return result, nfe, torch.stack(steps)
    return result, nfe


def get_pc_sampler(
    predictor_name: str,
    corrector_name: str,
    sde: SDE,
    score_fn: Callable,
    y: Tensor,
    generator: Optional[torch.Generator] = None,
    **kwargs,
):
    """A zero-argument callable running ``pc_sample`` on y (the reference
    API); it takes another `generator` by keyword."""

    def sampler(generator=generator):
        return pc_sample(sde, score_fn, y, predictor_name, corrector_name,
                         generator=generator, **kwargs)

    return sampler


def ode_sample(
    sde: SDE,
    score_fn: Callable,
    y: Tensor,
    N: Optional[int] = None,
    denoise: bool = True,
    eps: float = 3e-2,
    method: str = "rk4",
    rtol: float = 1e-5,
    atol: float = 1e-5,
    generator: Optional[torch.Generator] = None,
    prior: Optional[Tensor] = None,
):
    """Probability-flow ODE sampler. method "rk4": N fixed Runge-Kutta steps
    from T to eps on y's device; "rk45": scipy's adaptive ``solve_ivp`` on
    the host. With `denoise`, one noise-free reverse-diffusion step at eps
    follows. `prior` is the prior's standard-normal draw (batch, n_src,
    n_samples), else drawn from `generator`. Returns (x, nfe)."""
    if N is not None and N != sde.N:
        sde = sde.copy(N=N)
    x = sde.prior_sampling(y, generator=generator, z=None if prior is None else prior.to(y))
    b = y.shape[0]

    def drift(x, t: float):
        t = torch.full((b,), t, dtype=x.dtype, device=x.device)
        return reverse_sde(sde, score_fn, x, t, y, probability_flow=True)[0]

    if method == "rk4":
        ts = np.linspace(sde.T, eps, sde.N + 1).astype(np.float32)
        for i in range(sde.N):
            t0, h = float(ts[i]), float(ts[i + 1] - ts[i])
            k1 = drift(x, t0)
            k2 = drift(x + 0.5 * h * k1, t0 + 0.5 * h)
            k3 = drift(x + 0.5 * h * k2, t0 + 0.5 * h)
            k4 = drift(x + h * k3, float(ts[i + 1]))
            x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        nfe = 4 * sde.N
    elif method == "rk45":
        from scipy import integrate

        shape, dtype = x.shape, x.dtype

        def ode_func(t, flat):
            xt = torch.from_numpy(flat.reshape(shape)).to(device=y.device, dtype=dtype)
            return drift(xt, float(t)).double().cpu().numpy().ravel()

        sol = integrate.solve_ivp(ode_func, (sde.T, eps), x.double().cpu().numpy().ravel(),
                                  rtol=rtol, atol=atol, method="RK45")
        x = torch.from_numpy(sol.y[:, -1].reshape(shape)).to(device=y.device, dtype=dtype)
        nfe = int(sol.nfev)
    else:
        raise ValueError(f"unknown ODE method {method}")

    if denoise:
        t = torch.full((b,), eps, dtype=x.dtype, device=x.device)
        x = ReverseDiffusionPredictor(sde, score_fn).update(x, t, y)[1]
        nfe += 1
    return x, nfe
