"""diffsep_tpu_torch MixSDE vs diffsep_tpu MixSDE (CPU, float32).

Closed forms are elementwise float32 arithmetic on both sides; the
tolerance rtol=1e-5 allows for differing last-bit rounding of exp/pow.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsep_tpu.sde import base as jbase
from diffsep_tpu.sde.mixsde import MixSDE as JaxMixSDE
from diffsep_tpu_torch.sde import MixSDE, reverse_discretize, reverse_sde

RTOL, ATOL = 1e-5, 1e-6


def _pair(**kw):
    return JaxMixSDE(**kw), MixSDE(**kw)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.fixture
def inputs(rng):
    x = rng.standard_normal((3, 2, 50)).astype(np.float32)
    mix = rng.standard_normal((3, 1, 50)).astype(np.float32)
    t = np.array([0.03, 0.5, 1.0], np.float32)
    return x, mix, t


@pytest.mark.parametrize("kw", [{}, dict(d_lambda=1.0, sigma_min=0.1, sigma_max=0.8)])
def test_forward_sde_and_marginal(inputs, kw):
    js, ts = _pair(**kw)
    x, mix, t = inputs
    jd, jg = js.sde(jnp.asarray(x), jnp.asarray(t), jnp.asarray(mix))
    td, tg = ts.sde(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(mix))
    _close(td, jd)
    _close(tg, jg)
    jm, jL = js.marginal_prob(jnp.asarray(x), jnp.asarray(t), jnp.asarray(mix))
    tm, tL = ts.marginal_prob(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(mix))
    _close(tm, jm)
    _close(tL, jL)
    jf, jG = js.discretize(jnp.asarray(x), jnp.asarray(t), jnp.asarray(mix), dt=0.1)
    tf, tG = ts.discretize(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(mix), dt=0.1)
    _close(tf, jf)
    _close(tG, jG)


def test_std_operator_closed_forms(inputs):
    js, ts = _pair()
    x, _, t = inputs
    t_next = np.array([0.02, 0.4, 0.9], np.float32)
    jx, jt, jn = jnp.asarray(x), jnp.asarray(t), jnp.asarray(t_next)
    tx, tt, tn = torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(t_next)
    jL, tL = js._std(jt), ts._std(tt)
    _close(ts.mult_std(tL, tx), js.mult_std(jL, jx))
    _close(ts.mult_std_inv(tL, tx), js.mult_std_inv(jL, jx))
    # L^{-1} L x == x on the port side alone
    np.testing.assert_allclose(ts.mult_std_inv(tL, ts.mult_std(tL, tx)).numpy(), x, atol=1e-4)
    _close(ts.apply_mean(tt, tx), js.apply_mean(jt, jx))
    _close(ts.apply_mean_inv(tt, tx), js.apply_mean_inv(jt, jx))
    _close(ts.std_ratio(tn, tt), js.std_ratio(jn, jt))
    _close(ts.apply_std_ratio(tn, tt, tx), js.apply_std_ratio(jn, jt, jx))


def test_prior_sampling_with_the_jax_draw(inputs):
    js, ts = _pair()
    _, mix, _ = inputs
    key = jax.random.PRNGKey(3)
    want = js.prior_sampling(key, jnp.asarray(mix))
    z = np.array(jax.random.normal(key, (3, 2, 50), jnp.float32))
    got = ts.prior_sampling(torch.from_numpy(mix), z=torch.from_numpy(z))
    _close(got, want)
    g = torch.Generator().manual_seed(0)
    drawn = ts.prior_sampling(torch.from_numpy(mix), generator=g)
    assert drawn.shape == (3, 2, 50) and torch.isfinite(drawn).all()


@pytest.mark.parametrize("probability_flow", [False, True])
def test_reverse_sde_and_discretize(inputs, probability_flow):
    js, ts = _pair()
    x, mix, t = inputs
    jscore = lambda x, t, c: jnp.tanh(x) - c
    tscore = lambda x, t, c: torch.tanh(x) - c
    args_j = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(mix))
    args_t = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(mix))
    jd, jg = jbase.reverse_sde(js, jscore, *args_j, probability_flow=probability_flow)
    td, tg = reverse_sde(ts, tscore, *args_t, probability_flow=probability_flow)
    _close(td, jd)
    _close(tg, jg)
    jf, jG = jbase.reverse_discretize(js, jscore, *args_j, probability_flow=probability_flow)
    tf, tG = reverse_discretize(ts, tscore, *args_t, probability_flow=probability_flow)
    _close(tf, jf)
    _close(tG, jG)
