"""Score-matching training losses, with the PIT variants and the init hacks.

Counterpart of ``diffsep_tpu/train/losses.py:53-65, 115-530``. As there,
every loss calls the score network once: the network input of each PIT
loss does not depend on the permutation, so the permutation minimum acts
on closed-form whitened targets, and the init hacks 5/6/7 select per
sample between the init input (t = T) and the regular one before a single
forward.

Random draws. Each loss takes a ``Draws``, which hands out named draws of
the underlying primitive (uniform in [0, 1), standard normal, integers):
from its ``torch.Generator``, or, where its ``given`` mapping holds the
name, that value. The JAX package draws the same quantities from split
keys; the parity tests rebuild them there and give them here. The names:

  "time"     uniform (batch,), mapped to t by ``sample_time``
  "z"        normal, the target's shape: the regular branch's noise
  "z0"       normal, the target's shape: the init branch's noise (t = T)
  "shuffle"  uniform (batch, n_src), argsorted into a source order
  "sel"      integer (batch,) in [0, n_src!): the mmnr-PIT permutation
  "select"   uniform (batch,): init hack 4's pin to t = T
  "mask"     uniform (batch,): init hacks 5/6/7's Bernoulli(p) split
"""
from __future__ import annotations

import itertools
from typing import Callable, Mapping, Optional

import torch

Tensor = torch.Tensor
# score_fn(x_t, t, mix) -> score
ScoreFn = Callable[[Tensor, Tensor, Tensor], Tensor]


class Draws:
    """Named random draws from ``generator``, or from ``given`` where it
    holds the name (arrays or tensors of the asked shape)."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 given: Optional[Mapping[str, object]] = None):
        self.generator = generator
        self.given = dict(given or {})

    def _given(self, name: str, shape, device, dtype) -> Optional[Tensor]:
        if name not in self.given:
            return None
        v = torch.as_tensor(self.given[name]).to(device=device, dtype=dtype)
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"draw {name!r}: shape {tuple(v.shape)}, expected {tuple(shape)}")
        return v

    def uniform(self, name: str, shape, device) -> Tensor:
        v = self._given(name, shape, device, torch.float32)
        if v is None:
            v = torch.rand(shape, generator=self.generator, device=device)
        return v

    def normal(self, name: str, shape, device, dtype=torch.float32) -> Tensor:
        v = self._given(name, shape, device, dtype)
        if v is None:
            v = torch.randn(shape, generator=self.generator, device=device, dtype=dtype)
        return v

    def randint(self, name: str, shape, high: int, device) -> Tensor:
        v = self._given(name, shape, device, torch.int64)
        if v is None:
            v = torch.randint(high, shape, generator=self.generator, device=device)
        return v


# --------------------------------------------------------------------------
# batch utilities
# --------------------------------------------------------------------------
def normalize_batch(mix: Tensor, tgt: Optional[Tensor] = None):
    """Normalize by the mixture's mean and std over (chan, time); the std is
    Bessel-corrected and clamped at 1e-5. Returns ((mix, tgt), mean, std)."""
    mean = mix.mean(dim=(1, 2), keepdim=True)
    std = torch.clamp(mix.std(dim=(1, 2), keepdim=True, correction=1), min=1e-5)
    mix = (mix - mean) / std
    if tgt is not None:
        tgt = (tgt - mean) / std
    return (mix, tgt), mean, std


def denormalize_batch(x: Tensor, mean: Tensor, std: Tensor) -> Tensor:
    return x * std + mean


def _gather_sources(x: Tensor, idx: Tensor) -> Tensor:
    return torch.take_along_dim(x, idx.reshape(idx.shape + (1,) * (x.ndim - 2)), dim=1)


def shuffle_sources(draws: Draws, x: Tensor) -> Tensor:
    """An independent random source order per batch entry."""
    c = draws.uniform("shuffle", x.shape[:2], x.device)
    return _gather_sources(x, torch.argsort(c, dim=1, stable=True))


def select_elem_at_random(draws: Draws, x: Tensor, dim: int = -1) -> Tensor:
    """One random slice along ``dim`` per batch entry, the dim kept with
    size 1 (draw "sel")."""
    x = torch.movedim(x, dim, -1)
    idx = draws.randint("sel", (x.shape[0],), x.shape[-1], x.device)
    picked = torch.take_along_dim(x, idx.reshape((-1,) + (1,) * (x.ndim - 1)), dim=-1)
    return torch.movedim(picked, -1, dim)


def power_order_sources(x: Tensor) -> Tensor:
    """Sources ordered by increasing variance."""
    c = torch.var(x, dim=-1, correction=0)
    return _gather_sources(x, torch.argsort(c, dim=1, stable=True))


def sample_time(draws: Draws, sde, n: int, t_eps: float, strategy: str, device) -> Tensor:
    """t ~ U[t_eps, T] or variance-proportional."""
    u = draws.uniform("time", (n,), device)
    if strategy == "uniform":
        return u * (sde.T - t_eps) + t_eps
    if strategy == "varprop":
        return sde.sample_time_varprop(u, t_eps=t_eps)
    raise NotImplementedError(f"No sampling strategy {strategy}")


# --------------------------------------------------------------------------
# prior sampling with init hacks 1-4
# --------------------------------------------------------------------------
def sample_prior(draws: Draws, sde, mix: Tensor, target: Tensor, t_eps: float,
                 init_hack=False, t_rev_init: float = 0.03, time_strategy: str = "uniform"):
    time = sample_time(draws, sde, target.shape[0], t_eps, time_strategy, target.device)
    z = draws.normal("z", target.shape, target.device, target.dtype)
    true_mix = mix.expand(target.shape) / target.shape[1]

    if init_hack == 4:
        # pin a 1/N fraction of samples to t = T
        select = draws.uniform("select", time.shape, time.device) < 1.0 / sde.N
        time = torch.where(select, torch.full_like(time, sde.T), time)
        mean, L = sde.marginal_prob(target, time, mix)
        z = torch.where(select[:, None, None], z + sde.mult_std_inv(L, true_mix - mean), z)
        return mean + sde.mult_std(L, z), time, L, z

    mean, L = sde.marginal_prob(target, time, mix)
    if init_hack == 1:
        sel = (time < sde.T - t_rev_init)[:, None, None]
        z = torch.where(sel, z, z + sde.mult_std_inv(L, true_mix - mean))
        x_t = mean + sde.mult_std(L, z)
    elif init_hack in (2, 3):
        T, Tm = sde.T, sde.T - t_rev_init
        beta = torch.clamp((time - Tm) / (T - Tm), 0.0, 1.0)[:, None, None]
        x_t = true_mix * beta + mean * (1.0 - beta) + sde.mult_std(L, z)
        if init_hack == 3:
            z = sde.mult_std_inv(L, x_t - mean)
    else:
        x_t = mean + sde.mult_std(L, z)
    return x_t, time, L, z


# --------------------------------------------------------------------------
# losses: each calls the network once
# --------------------------------------------------------------------------
def _whitened_mse(L_pred: Tensor, z: Tensor) -> Tensor:
    """||L pred + z||^2 averaged over (src, time) -> (batch,)."""
    return ((L_pred + z) ** 2).mean(dim=(-2, -1))


def _permuted(x: Tensor, p) -> Tensor:
    """x with its sources (dim 1) in the order p, gathered by slices: an
    index list would be copied from host memory, which waits for the card."""
    return torch.stack([x[:, i] for i in p], dim=1)


def _perm_means(sde, target: Tensor, time: Tensor, mix: Tensor) -> Tensor:
    """The marginal mean under every source permutation: (batch, n_perm,
    src, samples)."""
    return torch.stack(
        [sde.marginal_prob(_permuted(target, p), time, mix)[0]
         for p in itertools.permutations(range(target.shape[1]))], dim=1)


def _mmnr_pit(sde, L: Tensor, L_pred: Tensor, z: Tensor, means: Tensor, mean_select: Tensor,
              mmnr_thresh_pit: float) -> Tensor:
    """The perm-min loss where the model-mismatch-to-noise ratio is below the
    threshold, the plain loss elsewhere."""
    err = means - mean_select[:, None]
    n_perm = means.shape[1]
    err_pow = (err ** 2).sum(dim=(1, 2, 3)) / ((n_perm - 1) * means.shape[2] * means.shape[3])
    noise_pow = (sde.mult_std(L, z) ** 2).mean(dim=(1, 2))
    mmnr = 10.0 * torch.log10(err_pow / torch.clamp(noise_pow, min=1e-5))
    loss_pit = torch.stack(
        [_whitened_mse(L_pred, z + sde.mult_std_inv(L, err[:, i])) for i in range(n_perm)], dim=-1
    ).min(dim=-1).values
    return torch.where(mmnr < mmnr_thresh_pit, loss_pit, _whitened_mse(L_pred, z))


def compute_score_loss(draws: Draws, sde, score_fn: ScoreFn, mix: Tensor, target: Tensor,
                       t_eps: float, init_hack=False, t_rev_init: float = 0.03,
                       time_strategy: str = "uniform") -> Tensor:
    """Plain denoising score matching -> (batch,)."""
    x_t, time, L, z = sample_prior(draws, sde, mix, target, t_eps, init_hack, t_rev_init, time_strategy)
    return _whitened_mse(sde.mult_std(L, score_fn(x_t, time, mix)), z)


def compute_score_loss_with_pit(draws: Draws, sde, score_fn: ScoreFn, mix: Tensor, target: Tensor,
                                t_eps: float, mmnr_thresh_pit: float = -10.0,
                                time_strategy: str = "uniform") -> Tensor:
    """mmnr-gated PIT score loss -> (batch,)."""
    b = target.shape[0]
    time = sample_time(draws, sde, b, t_eps, time_strategy, target.device)
    means = _perm_means(sde, target, time, mix)
    L = sde.marginal_prob(target, time, mix)[1]
    z = draws.normal("z", target.shape, target.device, target.dtype)
    sel = draws.randint("sel", (b,), means.shape[1], target.device)
    mean_select = means[torch.arange(b, device=sel.device), sel]
    pred = score_fn(mean_select + sde.mult_std(L, z), time, mix)
    return _mmnr_pit(sde, L, sde.mult_std(L, pred), z, means, mean_select, mmnr_thresh_pit)


def _perm_min(sde, L: Tensor, L_pred: Tensor, z: Tensor, target: Tensor, time: Tensor,
              mix: Tensor, mean_0: Tensor) -> Tensor:
    """min over permutations p of the loss against z + L^-1 (mean_0 - mean_p)."""
    return torch.stack(
        [_whitened_mse(L_pred, z + sde.mult_std_inv(L, mean_0 - mean_p))
         for mean_p in _perm_means(sde, target, time, mix).unbind(1)], dim=1
    ).min(dim=1).values


def compute_score_loss_with_pit_allthetime(draws: Draws, sde, score_fn: ScoreFn, mix: Tensor,
                                           target: Tensor, t_eps: float,
                                           time_strategy: str = "uniform") -> Tensor:
    """Perm-min score loss at every t -> (batch,)."""
    target = shuffle_sources(draws, target)
    time = sample_time(draws, sde, target.shape[0], t_eps, time_strategy, target.device)
    mean_0, L = sde.marginal_prob(target, time, mix)
    z0 = draws.normal("z", target.shape, target.device, target.dtype)
    L_pred = sde.mult_std(L, score_fn(mean_0 + sde.mult_std(L, z0), time, mix))
    return _perm_min(sde, L, L_pred, z0, target, time, mix, mean_0)


def compute_score_loss_init_hack_pit(draws: Draws, sde, score_fn: ScoreFn, mix: Tensor,
                                     target: Tensor) -> Tensor:
    """Perm-min mixture-consistent loss at t = T: x_t = mix/n + L z0 for
    every permutation, so one forward serves them all."""
    time = torch.full((mix.shape[0],), sde.T, dtype=mix.dtype, device=mix.device)
    true_mix = mix.expand(target.shape) / target.shape[1]
    z0 = draws.normal("z0", target.shape, target.device, target.dtype)
    L = sde.marginal_prob(target, time, mix)[1]
    L_pred = sde.mult_std(L, score_fn(true_mix + sde.mult_std(L, z0), time, mix))
    return _perm_min(sde, L, L_pred, z0, target, time, mix, true_mix)


# --------------------------------------------------------------------------
# init-hack 5/6/7 training steps: masked, one forward
# --------------------------------------------------------------------------
def _masked_init_step(draws: Draws, sde, score_fn: ScoreFn, mix: Tensor, target: Tensor,
                      t_eps: float, init_hack_p: float, regular_loss: str, mmnr_thresh_pit: float,
                      time_strategy: str) -> Tensor:
    """A per-sample Bernoulli(p) chooses between the init-PIT input (t = T,
    mixture-consistent) and the regular input; both losses come from one
    forward."""
    b, dev = mix.shape[0], mix.device
    pit_mask = draws.uniform("mask", (b,), dev) < init_hack_p

    # init branch (t = T)
    time_T = torch.full((b,), sde.T, dtype=mix.dtype, device=dev)
    true_mix = mix.expand(target.shape) / target.shape[1]
    z0 = draws.normal("z0", target.shape, dev, target.dtype)
    L_T = sde.marginal_prob(target, time_T, mix)[1]
    x_t_init = true_mix + sde.mult_std(L_T, z0)

    # regular branch
    if regular_loss not in ("plain", "pit", "allthetime"):
        raise ValueError(regular_loss)
    tgt_reg = shuffle_sources(draws, target)
    if regular_loss == "plain":
        x_t_reg, time_reg, L_reg, z_reg = sample_prior(
            draws, sde, mix, tgt_reg, t_eps, False, time_strategy=time_strategy)
    elif regular_loss == "pit":
        time_reg = sample_time(draws, sde, b, t_eps, time_strategy, dev)
        means = _perm_means(sde, tgt_reg, time_reg, mix)
        L_reg = sde.marginal_prob(tgt_reg, time_reg, mix)[1]
        z_reg = draws.normal("z", target.shape, dev, target.dtype)
        sel = draws.randint("sel", (b,), means.shape[1], dev)
        mean_select = means[torch.arange(b, device=dev), sel]
        x_t_reg = mean_select + sde.mult_std(L_reg, z_reg)
    else:  # allthetime
        time_reg = sample_time(draws, sde, b, t_eps, time_strategy, dev)
        mean_0, L_reg = sde.marginal_prob(tgt_reg, time_reg, mix)
        z_reg = draws.normal("z", target.shape, dev, target.dtype)
        x_t_reg = mean_0 + sde.mult_std(L_reg, z_reg)

    # fused forward
    x_t = torch.where(pit_mask[:, None, None], x_t_init, x_t_reg)
    time = torch.where(pit_mask, time_T, time_reg)
    pred = score_fn(x_t, time, mix)

    loss_init = _perm_min(sde, L_T, sde.mult_std(L_T, pred), z0, target, time_T, mix, true_mix)
    L_pred_reg = sde.mult_std(L_reg, pred)
    if regular_loss == "plain":
        loss_reg = _whitened_mse(L_pred_reg, z_reg)
    elif regular_loss == "pit":
        loss_reg = _mmnr_pit(sde, L_reg, L_pred_reg, z_reg, means, mean_select, mmnr_thresh_pit)
    else:
        loss_reg = _perm_min(sde, L_reg, L_pred_reg, z_reg, tgt_reg, time_reg, mix, mean_0)
    return torch.where(pit_mask, loss_init, loss_reg)


_REGULAR = {5: "plain", 6: "pit", 7: "allthetime"}


def training_loss(draws: Draws, sde, score_fn: ScoreFn, mix: Tensor, target: Tensor, t_eps: float,
                  init_hack=False, init_hack_p: float = 0.1, t_rev_init: float = 0.03,
                  train_source_order: str = "random", mmnr_thresh_pit: float = -10.0,
                  time_strategy: str = "uniform", sample_weight: Optional[Tensor] = None) -> Tensor:
    """The scalar batch loss, dispatched as ``training_loss`` of the JAX
    package: hacks 5/6/7 first, then PIT, then the plain loss after the
    source order. ``sample_weight`` (batch,) makes it a weighted mean."""
    if init_hack in _REGULAR:
        per = _masked_init_step(draws, sde, score_fn, mix, target, t_eps, init_hack_p,
                                _REGULAR[init_hack], mmnr_thresh_pit, time_strategy)
    elif train_source_order == "pit":
        per = compute_score_loss_with_pit(draws, sde, score_fn, mix, target, t_eps, mmnr_thresh_pit,
                                          time_strategy)
    else:
        if train_source_order == "power":
            target = power_order_sources(target)
        elif train_source_order == "random":
            target = shuffle_sources(draws, target)
        per = compute_score_loss(draws, sde, score_fn, mix, target, t_eps, init_hack, t_rev_init,
                                 time_strategy)
    if sample_weight is None:
        return per.mean()
    w = sample_weight.to(per.dtype)
    return (per * w).sum() / torch.clamp(w.sum(), min=1e-12)
