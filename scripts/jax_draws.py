"""The random draws of the JAX package's samplers and losses, replayed in the
layout that diffsep_tpu_torch takes as given draws (``noise`` of the
samplers, ``Draws`` of the losses): the same key gives the port the JAX
package's noise, so that the two can be compared step for step. Used by the
CPU parity tests (tests/test_torch_port_*.py) and scripts/nr_port_parity.py;
it imports JAX, so it never runs on the card.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch


def jax_pc_noise(key, shape, N: int, corrector_steps: int = 1):
    """The standard-normal draws diffsep_tpu's pc_sample makes from `key`,
    in the layout of diffsep_tpu_torch's `noise` argument: the prior from
    split(key) (pc.py), per step split(key, N) -> split(k) -> (kc, kp); the
    corrector draws normal(fold_in(kc, i)), the predictor normal(kp)."""
    key, prior_key = jax.random.split(key)
    noise = {"prior": np.array(jax.random.normal(prior_key, shape, jnp.float32))}
    corr, pred = [], []
    for k in jax.random.split(key, N):
        kc, kp = jax.random.split(k)
        corr.append([
            np.asarray(jax.random.normal(jax.random.fold_in(kc, i), shape, jnp.float32))
            for i in range(corrector_steps)
        ])
        pred.append(np.asarray(jax.random.normal(kp, shape, jnp.float32)))
    noise["corrector"] = np.asarray(corr, np.float32)
    noise["predictor"] = np.asarray(pred, np.float32)
    return {k: torch.from_numpy(v) for k, v in noise.items()}


def jax_loss_draws(key, shape, init_hack=False, order="random"):
    """The draws diffsep_tpu's training_loss makes from `key` for a target of
    `shape` (batch, n_src, samples), under the names of
    diffsep_tpu_torch.train.losses.Draws: the key splits of
    diffsep_tpu/train/losses.py replayed (training_loss :518, sample_prior
    :172-180, compute_score_loss_with_pit :253-266, _masked_init_step
    :366-405), each primitive drawn as it draws it. The time draw is the
    uniform in [0, 1) from which uniform(minval, maxval) and the varprop
    inverse CDF both start."""
    import math

    b, n, _ = shape
    draws = {}

    def time_z(kt, kz):
        draws["time"] = jax.random.uniform(kt, (b,))
        draws["z"] = jax.random.normal(kz, shape, jnp.float32)

    def sel(ks):
        draws["sel"] = jax.random.randint(ks, (b,), 0, math.factorial(n))

    if init_hack in (5, 6, 7):
        k_mask, k_init, k_reg, k_shuf = jax.random.split(key, 4)
        draws["mask"] = jax.random.uniform(k_mask, (b,))
        draws["z0"] = jax.random.normal(k_init, shape, jnp.float32)
        draws["shuffle"] = jax.random.uniform(k_shuf, (b, n))
        if init_hack == 6:
            kt, kz, ks = jax.random.split(k_reg, 3)
            sel(ks)
        else:
            kt, kz = jax.random.split(k_reg)
        time_z(kt, kz)
    elif order == "pit":
        kt, kz, ks = jax.random.split(key, 3)
        time_z(kt, kz)
        sel(ks)
    else:
        k_ord, key = jax.random.split(key)
        if order == "random":
            draws["shuffle"] = jax.random.uniform(k_ord, (b, n))
        kt, kz = jax.random.split(key)
        time_z(kt, kz)
        if init_hack == 4:
            draws["select"] = jax.random.uniform(jax.random.split(kz)[0], (b,))
    return {k: np.array(v) for k, v in draws.items()}


def jax_distill_draws(key, cfg, shape):
    """The draws diffsep_tpu's distill_loss makes from ``key`` for a target of
    ``shape``, under the names of the port's ``Draws``: its key splits
    (distill.py:202-234) replayed."""
    b, n_src, _ = shape
    draws = {}
    if cfg.source_order == "random":
        key, ko = jax.random.split(key)
        draws["shuffle"] = jax.random.uniform(ko, (b, n_src))
    ki, kz, kp = jax.random.split(key, 3)
    draws["i"] = jax.random.randint(ki, (b,), 0, cfg.n_student)
    draws["z"] = jax.random.normal(kz, shape, jnp.float32)
    if cfg.prior_mix_at_T > 0.0:
        kp, kp2 = jax.random.split(kp)
        draws["use_prior"] = jax.random.uniform(kp2, (b,))
    if cfg.on_policy_frac > 0.0:
        ko, kb = jax.random.split(jax.random.fold_in(kp, 1))
        draws["onpol_prior"] = jax.random.normal(ko, shape, jnp.float32)
        draws["use_onpol"] = jax.random.uniform(kb, (b,))
    return {k: np.array(v) for k, v in draws.items()}
