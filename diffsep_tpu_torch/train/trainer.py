"""Training core: configs, the optimizer, the train state, the train step
and the validation loss.

Counterpart of ``diffsep_tpu/train/trainer.py``, in the same order within a
step:

  1. the loss of one micro-batch, normalized by its mixture's statistics,
     and its gradients (``loss.backward()``);
  2. each micro-batch's gradient clipped (fixed norm or AutoClip);
  3. ``optax.MultiSteps``: the running mean of k clipped gradients,
     acc + (g - acc) / (i + 1), applied on the k-th micro-step;
  4. Adam (AdamW with weight decay) with optax's defaults, b1 0.9, b2 0.999,
     eps 1e-8, the learning rate of ``make_lr_schedule`` at the number of
     applied updates;
  5. the EMA updated only where the optimizer step was applied.

The optimizer holds every parameter of the score model, also the Fourier
projection's W, which takes no gradient (the JAX package's stop_gradient):
its gradient is zero, so Adam leaves it where it is and AdamW decays it, as
optax does. State is updated in place; step counters are host integers and
every tensor stays on the card, so a micro-step never waits for it.

Under data parallelism (``parallel/mesh.py``) the loss calls the score
model through its DDP wrapper, which averages the gradients over the ranks
in every micro-step's backward. Steps 2-5 then act on the global gradient,
as they do in the JAX package's dp step: the clip binds on the global norm,
not on each rank's, and every rank applies the same update.

Under ``trainer.strategy: fsdp`` (``shard_state``) the state holds this
rank's shard of each large parameter, of its Adam moments, accumulator and
EMA (``mesh.FsdpLayout``): steps 3-5 are elementwise and act on the shards
as they are; the clip takes the norm of the whole gradient, summed over the
shards (``FsdpLayout.global_norm``); ``state_dict`` gathers the whole
tensors, so a checkpoint is laid out as a one-process or DDP run's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch
from torch import nn

from ..parallel import mesh
from .clippers import AutoClipState, grad_norm, make_clipper
from .ema import EMA
from .losses import Draws, normalize_batch, training_loss

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Training-loss settings (the model section of the config)."""

    t_eps: float = 0.03
    t_rev_init: float = 0.03
    init_hack: object = False
    init_hack_p: float = 0.1
    train_source_order: str = "random"
    mmnr_thresh_pit: float = -10.0
    time_sampling_strategy: str = "uniform"


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-4
    weight_decay: float = 0.0
    lr_warmup: Optional[int] = None
    accumulate_grad_batches: int = 1
    ema_decay: float = 0.999
    grad_clipper: str = "fixed"  # "fixed" | "autoclip" | "none"
    clip_max_norm: float = 5.0
    autoclip_percentile: float = 10.0
    # decay after warmup: None | "exponential" (gamma) | "step" (step_size,
    # gamma) | "cosine" (t_max)
    scheduler: Optional[str] = None
    scheduler_gamma: float = 0.99
    scheduler_step_size: int = 1000
    scheduler_t_max: int = 100000


def make_lr_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """Linear warmup over the first ``lr_warmup`` updates, times the decay."""

    def decay(step: int) -> float:
        if cfg.scheduler == "exponential":
            return cfg.scheduler_gamma ** step
        if cfg.scheduler == "step":
            return cfg.scheduler_gamma ** math.floor(step / cfg.scheduler_step_size)
        if cfg.scheduler == "cosine":
            frac = min(max(step / cfg.scheduler_t_max, 0.0), 1.0)
            return 0.5 * (1.0 + math.cos(math.pi * frac))
        return 1.0

    if not cfg.lr_warmup:
        return lambda step: cfg.lr * decay(step)
    return lambda step: cfg.lr * min(1.0, (step + 1.0) / cfg.lr_warmup) * decay(step)


class Optimizer:
    """``optax.adam`` (``adamw`` where weight_decay > 0) inside
    ``optax.MultiSteps`` when accumulate_grad_batches > 1: the chain that
    ``make_optimizer`` of the JAX package builds."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, cfg: OptimConfig, params: Sequence[Tensor]):
        self.lr = make_lr_schedule(cfg)
        self.weight_decay = cfg.weight_decay
        self.k = cfg.accumulate_grad_batches
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0  # applied updates
        self.acc = [torch.zeros_like(p) for p in params] if self.k > 1 else None
        self.mini_step = 0
        self.gradient_step = 0

    @torch.no_grad()
    def update(self, params: List[Tensor], grads: List[Tensor]) -> bool:
        """Takes one micro-batch's gradients; returns whether the update was
        applied to ``params`` (in place)."""
        if self.k > 1:
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, diff)
            if self.mini_step < self.k - 1:
                self.mini_step += 1
                return False
            grads = self.acc
        lr = self.lr(self.count)
        self.count += 1
        b1, b2 = self.B1, self.B2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.EPS)
        step = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        torch._foreach_div_(step, denom)
        if self.weight_decay:
            torch._foreach_add_(step, params, alpha=self.weight_decay)
        torch._foreach_add_(params, step, alpha=-lr)
        if self.k > 1:
            torch._foreach_zero_(self.acc)
            self.mini_step = 0
            self.gradient_step += 1
        return True

    def state_dict(self, names: Sequence[str]) -> dict:
        return {
            "mu": dict(zip(names, self.mu)), "nu": dict(zip(names, self.nu)), "count": self.count,
            "acc": dict(zip(names, self.acc)) if self.acc is not None else None,
            "mini_step": self.mini_step, "gradient_step": self.gradient_step,
        }

    @torch.no_grad()
    def load_state_dict(self, state: Mapping, names: Sequence[str]) -> None:
        pairs = [(self.mu, state["mu"]), (self.nu, state["nu"])]
        if self.acc is not None:
            pairs.append((self.acc, state["acc"]))
        for mine, theirs in pairs:
            for t, name in zip(mine, names):
                t.copy_(theirs[name])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        self.gradient_step = int(state["gradient_step"])


@dataclasses.dataclass
class TrainState:
    """The mutable training state around a score model's parameters."""

    step: int  # micro-batches taken
    names: List[str]
    params: List[nn.Parameter]
    optimizer: Optimizer
    ema: EMA
    clip_state: Optional[AutoClipState]
    # set by train.loop.fit when it stopped for a preemption signal (not saved)
    preempted: bool = False
    # where the parameters live under trainer.strategy=fsdp (shard_state):
    # then ``params`` and every per-parameter tensor here are this rank's
    # shards
    fsdp: Optional[mesh.FsdpLayout] = None

    def _whole(self, tensors: Mapping[str, Tensor]) -> Dict[str, Tensor]:
        """Per-parameter tensors as whole tensors (gathered under fsdp)."""
        if self.fsdp is None:
            return dict(tensors)
        return {k: self.fsdp.gather(tensors[k], i) for i, k in enumerate(self.names)}

    def grad_holders(self) -> List[nn.Parameter]:
        """The parameters the backward writes gradients into."""
        return self.fsdp.params if self.fsdp is not None else self.params

    def state_dict(self) -> dict:
        """The whole state; under fsdp every rank must call (it gathers)."""
        clip = None
        if self.clip_state is not None:
            clip = {"history": self.clip_state.history, "count": self.clip_state.count}
        opt, ema = self.optimizer.state_dict(self.names), self.ema.state_dict(self.names)
        for d, k in ((opt, "mu"), (opt, "nu"), (opt, "acc"), (ema, "params")):
            if d[k] is not None:
                d[k] = self._whole(d[k])
        return {"step": self.step, "optimizer": opt, "ema": ema, "clip": clip}

    def load_state_dict(self, state: Mapping) -> None:
        """A whole state (before ``shard_state``)."""
        self.step = int(state["step"])
        self.optimizer.load_state_dict(state["optimizer"], self.names)
        self.ema.load_state_dict(state["ema"], self.names)
        if self.clip_state is not None:
            self.clip_state.history.copy_(state["clip"]["history"])
            self.clip_state.count = int(state["clip"]["count"])


def init_train_state(score_model: nn.Module, cfg: OptimConfig) -> TrainState:
    names, params = zip(*score_model.named_parameters())
    clipper = make_clipper(cfg.grad_clipper, cfg.clip_max_norm, cfg.autoclip_percentile)
    device = params[0].device
    return TrainState(
        step=0, names=list(names), params=list(params), optimizer=Optimizer(cfg, params),
        ema=EMA(params), clip_state=clipper.init(device) if clipper is not None else None,
    )


@torch.no_grad()
def shard_state(state: TrainState, layout: mesh.FsdpLayout) -> TrainState:
    """Keep only this rank's part of every per-parameter tensor of
    ``state`` (equal on every rank before), as ``layout`` splits the score
    model's parameters (``mesh.shard_fsdp``). Returns ``state``."""
    state.fsdp = layout
    opt = state.optimizer
    opt.mu = [layout.shard(t, i) for i, t in enumerate(opt.mu)]
    opt.nu = [layout.shard(t, i) for i, t in enumerate(opt.nu)]
    if opt.acc is not None:
        opt.acc = [layout.shard(t, i) for i, t in enumerate(opt.acc)]
    state.ema.params = [layout.shard(t, i) for i, t in enumerate(state.ema.params)]
    state.params = list(layout.local)
    return state


def step_generator(seed: int, step: int, device, rank: int = 0) -> torch.Generator:
    """The generator of one step's draws (the JAX package's fold_in(key,
    step)): seeded from (seed, step) alone, so a resumed run draws what an
    uninterrupted one would; a data-parallel rank adds its ``rank``, so the
    ranks draw for their rows independently (rank 0 draws what one process
    does)."""
    return torch.Generator(device=device).manual_seed((seed * 0x9E3779B1 + step + rank * 0x632BE5AB) % (1 << 63))


def make_loss_fn(score_model, sde, loss_cfg: LossConfig) -> Callable:
    """The loss of one micro-batch: (draws, mix, target, sample_weight=None)
    -> scalar, the batch normalized by its mixture's statistics first."""

    def loss_fn(draws, mix, target, sample_weight=None):
        (mix, target), _, _ = normalize_batch(mix, target)
        return training_loss(
            draws, sde, score_model, mix, target, t_eps=loss_cfg.t_eps, init_hack=loss_cfg.init_hack,
            init_hack_p=loss_cfg.init_hack_p, t_rev_init=loss_cfg.t_rev_init,
            train_source_order=loss_cfg.train_source_order, mmnr_thresh_pit=loss_cfg.mmnr_thresh_pit,
            time_strategy=loss_cfg.time_sampling_strategy, sample_weight=sample_weight,
        )

    return loss_fn


def apply_gradients(state: TrainState, clipper, ema_decay: float):
    """The update after ``loss.backward()``: every parameter's gradient
    (zero where it has none) clipped, the optimizer's step, the EMA where
    that step was applied; the gradients are released. Returns (gradient
    norm, clipped norm). Under fsdp each rank updates its shards, clipped
    by the norm of the whole gradient."""
    if state.fsdp is not None:
        grads = state.fsdp.grads()
        norm = state.fsdp.global_norm(grads)
    else:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in state.params]
        norm = grad_norm(grads)
    if clipper is not None:
        state.clip_state, (gnorm, thresh) = clipper(grads, state.clip_state, norm)
        clipped = torch.minimum(gnorm, thresh)
    else:
        gnorm = clipped = norm
    if state.optimizer.update(state.params, grads):
        state.ema.update(state.params, ema_decay)
    for p in state.grad_holders():
        p.grad = None
    return gnorm, clipped


def make_train_step(score_model: nn.Module, sde, loss_cfg: LossConfig, optim_cfg: OptimConfig,
                    seed: int, forward: Optional[nn.Module] = None) -> Callable:
    """The train step: (state, mix, target, sample_weight=None, draws=None)
    -> metrics, updating ``state`` and the model's parameters in place.
    ``draws`` hands the loss given draws (see ``losses.Draws``); under data
    parallelism, this rank's rows of them. ``forward`` is the module the
    loss calls, the DDP wrapper of ``score_model`` under data parallelism
    (``mesh.wrap_ddp``); the reported loss is then the mean over the ranks,
    the global batch's."""
    loss_fn = make_loss_fn(forward if forward is not None else score_model, sde, loss_cfg)
    clipper = make_clipper(optim_cfg.grad_clipper, optim_cfg.clip_max_norm, optim_cfg.autoclip_percentile)
    sched = make_lr_schedule(optim_cfg)
    rank = mesh.rank()

    def train_step(state: TrainState, mix: Tensor, target: Tensor, sample_weight=None,
                   draws: Optional[Mapping] = None) -> Dict[str, object]:
        for p in state.grad_holders():
            p.grad = None
        gen = step_generator(seed, state.step, mix.device, rank)
        loss = loss_fn(Draws(gen, draws), mix, target, sample_weight)
        loss.backward()
        gnorm, clipped = apply_gradients(state, clipper, optim_cfg.ema_decay)
        lr = sched(state.step // optim_cfg.accumulate_grad_batches)
        state.step += 1
        return {"train/score_loss": mesh.all_reduce_mean(loss.detach().clone()), "grad/norm": gnorm,
                "grad/clipped_norm": clipped, "grad/step_size": lr * clipped, "lr": lr}

    return train_step


def make_val_score_loss(score_model: nn.Module, sde, loss_cfg: LossConfig, seed: int) -> Callable:
    """Validation score loss with the training loss's dispatch: (mix, target,
    step) -> loss, without gradients, on whatever weights the model holds."""
    loss_fn = make_loss_fn(score_model, sde, loss_cfg)

    @torch.no_grad()
    def val_loss(mix: Tensor, target: Tensor, step: int) -> Tensor:
        return loss_fn(Draws(step_generator(seed, step, mix.device)), mix, target)

    return val_loss
