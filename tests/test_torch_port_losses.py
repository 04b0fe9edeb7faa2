"""The port's training loss against the JAX package's, value and parameter
gradients, on a tiny NCSN++ in float32 with seeded random weights.

The JAX draws are rebuilt from the same key (``jax_loss_draws``) and handed
to the port. Tolerances: the loss within 1e-5 of its value (measured
<= 5e-6: the network's float32 sums in another order), every parameter
gradient within 1e-4 of the global gradient norm (measured <= 3e-6).
The JAX network runs under one jit (compiled once for the module), the loss
around it op by op, so a variant costs about a second.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import jax_loss_draws, jax_score_model, load_port_weights, port_score_model, random_params
from diffsep_tpu.sde.mixsde import MixSDE as JaxMixSDE
from diffsep_tpu.train import losses as jax_losses
from diffsep_tpu_torch.models import state_dict_from_jax
from diffsep_tpu_torch.sde.mixsde import MixSDE
from diffsep_tpu_torch.train import losses
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

B, T = 4, 1000
# N = 3 makes init hack 4 pin a third of the batch to T; t_rev_init = 0.5
# makes hacks 1-3 act on about half of it; p = 0.5 splits hacks 5-7's batch
# (the key below draws the mask 0.70, 0.23, 0.82, 0.17); the mmnr threshold
# of 10 dB puts both branches of the PIT gate in the batch.
N_STEPS = 3
KW = dict(t_eps=0.03, init_hack_p=0.5, t_rev_init=0.5, mmnr_thresh_pit=10.0)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    jm = jax_score_model()
    params = random_params(jm, rng)
    pm = port_score_model()
    load_port_weights(pm, params)
    mix = rng.standard_normal((B, 1, T)).astype(np.float32)
    tgt = rng.standard_normal((B, 2, T)).astype(np.float32)
    weight = np.array([1.0, 0.0, 2.0, 0.5], np.float32)
    return dict(net=jax.jit(jm.apply), params=params, pm=pm, mix=mix, tgt=tgt, weight=weight)


CASES = [(hack, "power", "uniform", False) for hack in (False, 1, 2, 3, 4, 5, 6, 7)] + [
    (False, "random", "uniform", False), (False, "pit", "uniform", False),
    (5, "power", "varprop", False), (False, "random", "uniform", True), (7, "pit", "varprop", True),
]


@pytest.mark.parametrize("init_hack,order,strategy,weighted", CASES)
def test_training_loss_and_gradients_match_jax(setup, init_hack, order, strategy, weighted):
    s = setup
    key = jax.random.PRNGKey(1)
    kw = dict(KW, init_hack=init_hack, train_source_order=order, time_strategy=strategy)
    weight = s["weight"] if weighted else None

    def jax_loss(p):
        return jax_losses.training_loss(
            key, JaxMixSDE(N=N_STEPS), lambda x, t, m: s["net"]({"params": p}, x, t, m),
            jnp.asarray(s["mix"]), jnp.asarray(s["tgt"]),
            sample_weight=None if weight is None else jnp.asarray(weight), **kw)

    want, grads = jax.value_and_grad(jax_loss)(s["params"])
    draws = jax_loss_draws(key, s["tgt"].shape, init_hack, order)
    pm = s["pm"]
    pm.zero_grad(set_to_none=True)
    got = losses.training_loss(
        losses.Draws(given=draws), MixSDE(N=N_STEPS), pm, torch.from_numpy(s["mix"]),
        torch.from_numpy(s["tgt"]), sample_weight=None if weight is None else torch.from_numpy(weight), **kw)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))

    want_g = state_dict_from_jax(grads)
    got_g = {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in pm.named_parameters()}
    assert set(got_g) == set(want_g)
    norm = torch.sqrt(sum((g ** 2).sum() for g in want_g.values())).item()
    assert norm > 0
    err = max((got_g[k] - want_g[k]).abs().max().item() for k in want_g)
    assert err <= 1e-4 * norm, err / norm


def test_varprop_times_match_jax():
    u = jax.random.uniform(jax.random.PRNGKey(3), (64,))
    want = np.asarray(JaxMixSDE().sample_time_varprop(jax.random.PRNGKey(3), 64, t_eps=0.03))
    got = MixSDE().sample_time_varprop(torch.from_numpy(np.asarray(u)), t_eps=0.03).numpy()
    assert np.allclose(got, want, atol=1e-6, rtol=0)


def test_batch_utilities_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 3, 50)).astype(np.float32) * np.array([3.0, 1.0, 2.0], np.float32)[:, None]
    mix = rng.standard_normal((3, 1, 50)).astype(np.float32)
    (m_j, t_j), mean_j, std_j = jax_losses.normalize_batch(jnp.asarray(mix), jnp.asarray(x))
    (m_p, t_p), mean_p, std_p = losses.normalize_batch(torch.from_numpy(mix), torch.from_numpy(x))
    for a, b in ((m_p, m_j), (t_p, t_j), (mean_p, mean_j), (std_p, std_j)):
        assert np.allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert np.array_equal(losses.power_order_sources(torch.from_numpy(x)).numpy(),
                          np.asarray(jax_losses.power_order_sources(jnp.asarray(x))))
    key = jax.random.PRNGKey(7)
    shuffle = np.asarray(jax.random.uniform(key, (3, 3)))
    assert np.array_equal(losses.shuffle_sources(losses.Draws(given={"shuffle": shuffle}), torch.from_numpy(x)).numpy(),
                          np.asarray(jax_losses.shuffle_sources(key, jnp.asarray(x))))
    idx = np.asarray(jax.random.randint(key, (3,), 0, 3))
    assert np.array_equal(
        losses.select_elem_at_random(losses.Draws(given={"sel": idx}), torch.from_numpy(x), dim=1).numpy(),
        np.asarray(jax_losses.select_elem_at_random(key, jnp.asarray(x), dim=1)))


@pytest.mark.parametrize("fn", ["allthetime", "init_hack_pit"])
def test_standalone_pit_losses_match_jax(setup, fn):
    """The two PIT losses that training_loss reaches only inside hack 7, or
    not at all, called on their own."""
    s = setup
    key = jax.random.PRNGKey(2)
    mix, tgt = jnp.asarray(s["mix"]), jnp.asarray(s["tgt"])
    score = lambda x, t, m: s["net"]({"params": s["params"]}, x, t, m)  # noqa: E731
    if fn == "allthetime":
        want = jax_losses.compute_score_loss_with_pit_allthetime(key, JaxMixSDE(), score, mix, tgt, 0.03)
        kt, kz, ksh = jax.random.split(key, 3)
        draws = {"time": jax.random.uniform(kt, (B,)), "z": jax.random.normal(kz, tgt.shape),
                 "shuffle": jax.random.uniform(ksh, (B, 2))}
    else:
        want = jax_losses.compute_score_loss_init_hack_pit(key, JaxMixSDE(), score, mix, tgt)
        draws = {"z0": jax.random.normal(key, tgt.shape)}
    draws = {k: np.array(v) for k, v in draws.items()}
    port_fn = (losses.compute_score_loss_with_pit_allthetime if fn == "allthetime"
               else losses.compute_score_loss_init_hack_pit)
    args = (0.03,) if fn == "allthetime" else ()
    with torch.no_grad():
        got = port_fn(losses.Draws(given=draws), MixSDE(), s["pm"], torch.from_numpy(s["mix"]),
                      torch.from_numpy(s["tgt"]), *args)
    assert np.allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=0)
