"""Progressive distillation of the mixing-SDE score model into a few-step
DDIM student (Salimans & Ho, "Progressive Distillation for Fast Sampling of
Diffusion Models", ICLR 2022, re-derived for MixSDE and PriorMixSDE).

Counterpart of ``diffsep_tpu/train/distill.py``. The student learns a
deterministic N-step DDIM sampler from a teacher that runs the same
transition at a finer resolution:

* a step takes the data prediction ``x0_hat = M(t)^-1 (x_t + Sigma(t)
  score)`` and transports between exact marginals, ``x_t' = M(t') x0 +
  L(t') L(t)^-1 (x_t - M(t) x0)``: the "ddim" predictor's own functions;
* the teacher integrates the same interval in ``teacher_substeps``
  micro-steps;
* the transport is affine in x0 and every operator is diagonal in the
  {A, Pn} projector basis, so the x0 for which one student step lands on
  the teacher's endpoint has a closed form (``invert_ddim_x0``):
  x_next - R x_t = (M(t') - R M(t)) x0 with R = L(t') L(t)^-1 and
  M(t') - R M(t) = (1 - r1) A + (e^{-lam t'} - r2 e^{-lam t}) Pn,
  r_k = sqrt(ev_k(t') / ev_k(t)). PriorMixSDE's envelope does not depend
  on t and cancels in R.

The grid is ``sampling/pc.py``'s ``make_timesteps``: steps i < N - 1
transport ts[i] -> ts[i + 1], and the last step's output is the data
prediction itself, whose target is the teacher's own. A student distilled
at N therefore serves through the stock sampler: ``predictor_name="ddim",
corrector_name="none", N=N``.

Random draws go through ``losses.Draws`` (the tests hand it the JAX
package's draws), by name:

  "shuffle"      uniform (batch, n_src): the source order (order "random")
  "i"            integer (batch,) in [0, N): the grid step of each row
  "z"            normal, the target's shape: x_t's noise
  "use_prior"    uniform (batch,): at i == 0, x_t from the sampling prior
  "onpol_prior"  normal, the target's shape: the on-policy run's prior draw
  "use_onpol"    uniform (batch,): x_t from the student's own trajectory

The teacher is a frozen copy of the student's starting weights and runs
without autograd; so does the student's on-policy trajectory. The update
is the score training's (clip, Adam, EMA on applied steps;
``trainer.apply_gradients``), so a distilled student checkpoints and
loads like any run.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import logging
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn

from ..parallel import mesh
from ..sampling.pc import make_timesteps
from ..sampling.predictors import data_prediction, ddim_transition
from ..sde.mixsde import mix_mats
from .checkpoints import atomic_save, load_payload
from .clippers import make_clipper
from .losses import Draws, normalize_batch, power_order_sources, shuffle_sources
from .trainer import OptimConfig, TrainState, apply_gradients, step_generator

Tensor = torch.Tensor
log = logging.getLogger(__name__)

__all__ = ["DistillConfig", "data_prediction", "ddim_transition", "ddim_transport", "distill_loss",
           "distill_stage", "invert_ddim_x0", "make_distill_step", "progressive_distill",
           "snr_channel_weights"]


def ddim_transport(sde, score_fn: Callable, x: Tensor, t: Tensor, t_next: Tensor, cond: Tensor,
                   substeps: int = 2):
    """Integrate t -> t_next in ``substeps`` DDIM micro-steps on a linear
    subgrid. Returns (x_end, the last micro-step's x0_hat)."""
    x0_hat = None
    for j in range(substeps):
        a0, a1 = j / substeps, (j + 1) / substeps
        tj = t * (1.0 - a0) + t_next * a0
        tj1 = t * (1.0 - a1) + t_next * a1
        x0_hat = data_prediction(sde, score_fn, x, tj, cond)
        x = ddim_transition(sde, x, tj, tj1, x0_hat)
    return x, x0_hat


def _transport_eigcoeffs(sde, t: Tensor, t_next: Tensor):
    """Eigen-coefficients of M(t') - R M(t) along (A, Pn)."""
    ev1, ev2 = sde._cov_eigval(t)
    ev1n, ev2n = sde._cov_eigval(t_next)
    r1 = torch.sqrt(ev1n / ev1)
    r2 = torch.sqrt(ev2n / ev2)
    cA = 1.0 - r1
    cP = torch.exp(-sde.d_lambda * t_next) - r2 * torch.exp(-sde.d_lambda * t)
    return cA, cP


def invert_ddim_x0(sde, x_t: Tensor, t: Tensor, t_next: Tensor, x_next: Tensor) -> Tensor:
    """The x0 for which one DDIM step from (x_t, t) lands on (x_next, t').
    The denominators are kept away from zero (1e-12) so that the identity
    transport t' == t stays finite; callers select that case away."""
    resid = x_next - sde.apply_std_ratio(t_next, t, x_t)
    cA, cP = _transport_eigcoeffs(sde, t, t_next)
    tiny = 1e-12
    cA = torch.where(cA.abs() > tiny, cA, torch.ones_like(cA))
    cP = torch.where(cP.abs() > tiny, cP, torch.ones_like(cP))
    A, Pn = mix_mats(x_t.shape[1], x_t.dtype, x_t.device)
    inv = (1.0 / cA)[:, None, None] * A + (1.0 / cP)[:, None, None] * Pn
    return inv @ resid


def snr_channel_weights(sde, t: Tensor, cond: Optional[Tensor] = None):
    """Truncated per-eigenchannel SNR weights max(alpha_k^2 / sigma_k^2, 1)
    (Salimans & Ho 2022, eq. 10), alpha_A = 1, alpha_Pn = e^{-lam t}. Where
    ``cond`` is given and the SDE has PriorMixSDE's envelope, sigma_k^2 is
    env^2 ev_k: the envelope does not cancel in a plain SNR. Returns (b, 1,
    1)- or (b, 1, samples)-shaped weights."""
    ev1, ev2 = sde._cov_eigval(t)
    snr1 = (1.0 / ev1)[:, None, None]
    snr2 = (torch.exp(-2.0 * sde.d_lambda * t) / ev2)[:, None, None]
    if cond is not None and hasattr(sde, "_std_sigma_mix"):
        env = sde._std_sigma_mix(cond)
        env2 = (env * env).to(snr1.dtype)
        snr1 = snr1 / env2
        snr2 = snr2 / env2
    return torch.clamp(snr1, min=1.0), torch.clamp(snr2, min=1.0)


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """The distillation's settings."""

    n_student: int = 8  # the student's steps, its serving N
    t_eps: float = 0.03  # the grid's end, the model's t_eps
    # the time grid, with pc_sample's `schedule` semantics (None =
    # linspace(T, eps, N); "linear"/"log"/"revlog"): distill and serve with
    # the same value
    schedule: Optional[str] = None
    teacher_substeps: int = 2  # teacher micro-steps per student step
    weighting: str = "truncated_snr"  # "truncated_snr" | "none"
    source_order: str = "power"  # the teacher's training convention
    # probability that a row at i == 0 starts from the sampling prior (mean
    # mix / n) instead of the forward marginal: the prior the sampler serves
    prior_mix_at_T: float = 0.5
    # probability that a row's x_t is the student's own DDIM trajectory at
    # ts[i] (no gradient through it), the input it meets when serving
    on_policy_frac: float = 0.0


@functools.lru_cache(maxsize=64)
def _grid(T: float, eps: float, n: int, schedule: Optional[str], device: torch.device) -> Tensor:
    """``make_timesteps``' grid on ``device``, made once: a copy from host
    memory on every step would wait for the card."""
    return torch.from_numpy(make_timesteps(T, eps, n, schedule)[0]).to(device)


def distill_loss(draws: Draws, sde, student_score_fn: Callable, teacher_score_fn: Callable, mix: Tensor,
                 target: Tensor, cfg: DistillConfig) -> Tensor:
    """The x0-space regression loss, a scalar. The inputs are already
    normalized (the step normalizes the batch).

    The on-policy trajectory takes N - 1 student evaluations: the JAX
    package's ``lax.scan`` makes N, the last of which feeds no state that a
    row can pick (its states are the pre-step ones), so it is left out."""
    n = cfg.n_student
    dev = target.device
    ts = _grid(float(sde.T), float(cfg.t_eps), n, cfg.schedule, dev)

    if cfg.source_order == "power":
        target = power_order_sources(target)
    elif cfg.source_order == "random":
        target = shuffle_sources(draws, target)

    b = target.shape[0]
    i = draws.randint("i", (b,), n, dev)
    is_last = i == n - 1
    t = ts[i]
    t_next = torch.where(is_last, t, ts[torch.clamp(i + 1, max=n - 1)])

    # x_t ~ q(x_t | x0); at the top of the grid, optionally from the prior
    # the sampler starts from
    mean, L = sde.marginal_prob(target, t, mix)
    z = draws.normal("z", target.shape, dev, target.dtype)
    x_t = mean + sde.mult_std(L, z)
    if cfg.prior_mix_at_T > 0.0:
        use_prior = (i == 0) & (draws.uniform("use_prior", (b,), dev) < cfg.prior_mix_at_T)
        x_prior = (mix / target.shape[1]).expand(target.shape) + sde.mult_std(L, z)
        x_t = torch.where(use_prior[:, None, None], x_prior, x_t)

    if cfg.on_policy_frac > 0.0:
        x = sde.prior_sampling(mix, z=draws.normal("onpol_prior", target.shape, dev, target.dtype))
        traj = [x]
        with torch.no_grad():
            for j in range(n - 1):
                tj, tj1 = ts[j].expand(b), ts[j + 1].expand(b)
                x = ddim_transition(sde, x, tj, tj1, data_prediction(sde, student_score_fn, x, tj, mix))
                traj.append(x)
        x_onpol = torch.stack(traj)[i, torch.arange(b, device=dev)]
        use_onpol = draws.uniform("use_onpol", (b,), dev) < cfg.on_policy_frac
        x_t = torch.where(use_onpol[:, None, None], x_onpol, x_t)

    # the teacher's fine transport over the student's interval (the
    # identity where is_last, whose target is the teacher's x0_hat)
    with torch.no_grad():
        x_end, teacher_x0 = ddim_transport(sde, teacher_score_fn, x_t, t, t_next, mix, cfg.teacher_substeps)
        x0_inv = invert_ddim_x0(sde, x_t, t, t_next, x_end)
        x0_target = torch.where(is_last[:, None, None], teacher_x0, x0_inv)

    r = data_prediction(sde, student_score_fn, x_t, t, mix) - x0_target
    if cfg.weighting == "truncated_snr":
        A, Pn = mix_mats(r.shape[1], r.dtype, dev)
        w1, w2 = snr_channel_weights(sde, t, mix)
        per = (w1 * (A @ r) ** 2).mean(dim=(-2, -1)) + (w2 * (Pn @ r) ** 2).mean(dim=(-2, -1))
    elif cfg.weighting == "none":
        per = (r**2).mean(dim=(-2, -1))
    else:
        raise ValueError(f"unknown weighting '{cfg.weighting}'")
    return per.mean()


def make_distill_step(student: nn.Module, sde, optim_cfg: OptimConfig, seed: int,
                      distill_cfg: DistillConfig, forward: Optional[nn.Module] = None) -> Callable:
    """The distillation step: (state, teacher, mix, target, draws=None) ->
    metrics, updating ``state`` and the student's parameters in place with
    the score training's update (clip, optimizer, EMA on applied steps).
    ``teacher`` is a score module that takes no gradient; ``draws`` hands the
    loss given draws. Step k draws from ``step_generator(seed, k)``.

    Data-parallel distillation: ``forward`` is the student's DDP wrapper
    (``parallel/mesh.wrap_ddp``), each rank passes its rows of the batch
    (and of ``draws``) and its own frozen teacher, outside DDP; the update
    then acts on the gradient averaged over the ranks, and the reported
    loss is the mean over them."""
    clipper = make_clipper(optim_cfg.grad_clipper, optim_cfg.clip_max_norm, optim_cfg.autoclip_percentile)
    student_fn = forward if forward is not None else student
    rank = mesh.rank()

    def distill_step(state: TrainState, teacher: nn.Module, mix: Tensor, target: Tensor,
                     draws: Optional[Mapping] = None) -> Dict[str, Tensor]:
        for p in state.params:
            p.grad = None
        (mix, target), _, _ = normalize_batch(mix, target)
        gen = step_generator(seed, state.step, mix.device, rank)
        loss = distill_loss(Draws(gen, draws), sde, student_fn, teacher, mix, target, distill_cfg)
        loss.backward()
        gnorm, _ = apply_gradients(state, clipper, optim_cfg.ema_decay)
        state.step += 1
        return {"distill/loss": mesh.all_reduce_mean(loss.detach().clone()), "grad/norm": gnorm}

    return distill_step


def frozen_copy(module: nn.Module) -> nn.Module:
    """A copy of ``module`` that takes no gradient: the teacher."""
    return copy.deepcopy(module).requires_grad_(False).eval()


def ema_state_dict(model, state: TrainState) -> Dict[str, Tensor]:
    """The score model's state dict with the EMA weights of ``state``."""
    sd = {k: v.detach().clone() for k, v in model.score_model.state_dict().items()}
    sd.update({name: p.detach().clone() for name, p in zip(state.names, state.ema.params)})
    return sd


def stage_seed(seed: int, stage: int) -> int:
    """The step generators' seed of stage ``stage`` (the JAX package's
    ``fold_in(key, stage)``)."""
    return seed * 1_000_003 + stage


def distill_stage(model, batch_fn: Callable[[int], tuple], cfg: DistillConfig, steps: int, seed: int,
                  log_every: int = 0) -> TrainState:
    """Distill ``model``'s score model, from the weights it holds, into an
    ``cfg.n_student``-step student for ``steps`` steps; the teacher is a
    frozen copy of those weights. ``batch_fn(step)`` gives (mix, target) on
    the model's device. Returns the train state; the model holds the trained
    (not the EMA) weights."""
    teacher = frozen_copy(model.score_model)
    state = model.init_state()
    step_fn = make_distill_step(model.score_model, model.sde, model.optim_cfg, seed, cfg)
    for step in range(steps):
        mix, target = batch_fn(step)
        metrics = step_fn(state, teacher, mix, target)
        if log_every and (step + 1) % log_every == 0:
            log.info("[distill N=%d] step %d: loss %.5f", cfg.n_student, step + 1,
                     float(metrics["distill/loss"]))
    return state


def stage_cache_file(cache_dir, stage: int, n: int) -> Path:
    """The file of stage ``stage`` (an ``n``-step student) in a stage cache."""
    return Path(cache_dir) / f"stage{stage}_N{int(n)}.pt"


def progressive_distill(model, batch_fn: Callable[[int], tuple], stages=(16, 8, 4, 2), steps_per_stage: int = 1000,
                        seed: int = 0, teacher_substeps: int = 2, log_every: int = 0,
                        stage_cache_dir: Optional[str] = None, **cfg_kwargs) -> Dict[int, Dict[str, Tensor]]:
    """The halving schedule: each stage distills an N-step student from the
    previous stage's EMA weights (the first from the weights ``model``
    holds). Returns {N: the stage's EMA state dict}; the model holds the
    last stage's.

    ``stage_cache_dir`` makes the schedule resumable: each finished stage's
    EMA state dict is saved there as ``stage{i}_N{n}.pt``, written to a
    temporary file and moved into place (a cut write leaves no file under
    that name), and a rerun loads it instead of training the stage. The
    caller keys the directory by what a stage depends on (teacher, seed,
    schedule, steps): a file there is loaded as it is."""
    cache_dir = None
    if stage_cache_dir is not None:
        cache_dir = Path(stage_cache_dir)
        cache_dir.mkdir(parents=True, exist_ok=True)
    out = {}
    for si, n in enumerate(stages):
        n = int(n)
        cache = stage_cache_file(cache_dir, si, n) if cache_dir is not None else None
        if cache is not None and cache.exists():
            out[n] = load_payload(cache, map_location=model.device)
            model.score_model.load_state_dict(out[n], strict=True)
            log.info("[distill N=%d] stage loaded from cache %s", n, cache)
            continue
        cfg = DistillConfig(n_student=n, t_eps=model.t_eps, teacher_substeps=teacher_substeps,
                            source_order=model.loss_cfg.train_source_order, **cfg_kwargs)
        state = distill_stage(model, batch_fn, cfg, steps_per_stage, stage_seed(seed, si), log_every)
        out[n] = ema_state_dict(model, state)
        model.score_model.load_state_dict(out[n], strict=True)
        if cache is not None:
            atomic_save(out[n], cache)
    return out
