"""The enhancement recipe's SDEs: diffsep_tpu_torch's PriorMixSDE, OUVESDE
and OUVPSDE against diffsep_tpu's (CPU, float32), method by method.

Both sides do the same float32 elementwise arithmetic, held to 1e-5
relative with an absolute floor of 1e-6, as tests/test_torch_port_sde.py
holds MixSDE. What carries PriorMixSDE's envelope is held to 1e-5 of its
scale (rtol 1e-5, atol 1e-5 x max |value|): the envelope is a float32
cumsum of mix^2, summed by XLA and torch in different orders, and its
rounding is that of the running sum, not of one window's power; so is
mult_std_inv's solve (the closed 2 x 2 form cancels at like entries). On a
mixture with a stretch 60 dB down, where the envelope's 1e-4 clamp acts,
the cumsum's rounding relative to those quiet windows is 4e-4 and the
solve (which divides by the envelope) reaches 2.9e-5 of scale (measured),
so that case is held to 1e-4 of scale. The mixtures are 2000 samples,
longer than the 510-sample window; mult_std_inv at ndim > 2 is a batched
solve on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsep_tpu.sde import base as jbase
from diffsep_tpu.sde.mixsde import PriorMixSDE as JaxPriorMixSDE
from diffsep_tpu.sde.ouve import OUVESDE as JaxOUVESDE
from diffsep_tpu.sde.ouve import OUVPSDE as JaxOUVPSDE
from diffsep_tpu_torch.sde import OUVESDE, OUVPSDE, PriorMixSDE, reverse_discretize, reverse_sde

RTOL, ATOL = 1e-5, 1e-6
B, T = 3, 2000


def _close(got, want, of_scale=None):
    """``of_scale``: the absolute tolerance as a fraction of max |want|, for
    what carries PriorMixSDE's envelope (see above)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    atol = ATOL if of_scale is None else of_scale * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


# the tolerance of scale for each mixture (see above)
QUIET = {False: 1e-5, True: 1e-4}


@pytest.fixture
def inputs(rng):
    def make(ndim, quiet=False):
        x = rng.standard_normal((B, ndim, T)).astype(np.float32)
        mix = rng.standard_normal((B, 1, T)).astype(np.float32)
        if quiet:  # a stretch where the envelope's 1e-4 clamp acts
            mix[:, :, 700:1500] *= 1e-3
        t = np.array([0.03, 0.5, 1.0], np.float32)
        t_next = np.array([0.02, 0.4, 0.9], np.float32)
        return x, mix, t, t_next

    return make


@pytest.mark.parametrize("quiet", [False, True])
@pytest.mark.parametrize("ndim", [2, 3])
def test_prior_mix_envelope_sde_and_marginal(inputs, ndim, quiet):
    js, ts = JaxPriorMixSDE(ndim=ndim), PriorMixSDE(ndim=ndim)
    (jx, jm, jt, _), (tx, tm, tt, _) = _both(*inputs(ndim, quiet))
    tol = QUIET[quiet]
    _close(ts._std_sigma_mix(tm), js._std_sigma_mix(jm), tol)
    for got, want in zip(ts.sde(tx, tt, tm), js.sde(jx, jt, jm)):
        _close(got, want, tol)
    for got, want in zip(ts.marginal_prob(tx, tt, tm), js.marginal_prob(jx, jt, jm)):
        _close(got, want, tol)
    for got, want in zip(ts.discretize(tx, tt, tm, dt=0.1), js.discretize(jx, jt, jm, dt=0.1)):
        _close(got, want, tol)
    _close(ts._var(tt), js._var(jt))


@pytest.mark.parametrize("quiet", [False, True])
@pytest.mark.parametrize("ndim", [2, 3])
def test_prior_mix_std_algebra(inputs, ndim, quiet):
    js, ts = JaxPriorMixSDE(ndim=ndim), PriorMixSDE(ndim=ndim)
    (jx, jm, jt, jn), (tx, tm, tt, tn) = _both(*inputs(ndim, quiet))
    tol = QUIET[quiet]
    jL, tL = js._std(jt, jm), ts._std(tt, tm)
    _close(tL, jL, tol)
    _close(ts.mult_std(tL, tx), js.mult_std(jL, jx), tol)
    # the closed-form 2 x 2 solve (ndim 2) or the batched solve (ndim 3),
    # on the same L and on each side's own
    _close(ts.mult_std_inv(tL, tx), js.mult_std_inv(jnp.asarray(tL.numpy()), jx), tol)
    _close(ts.mult_std_inv(tL, tx), js.mult_std_inv(jL, jx), tol)
    np.testing.assert_allclose(ts.mult_std_inv(tL, ts.mult_std(tL, tx)).numpy(), tx.numpy(), atol=1e-4)
    _close(ts.mean_mat_inv(tt), js.mean_mat_inv(jt))
    _close(ts.apply_mean_inv(tt, tx), js.apply_mean_inv(jt, jx))
    _close(ts.apply_mean(tt, tx), js.apply_mean(jt, jx))
    _close(ts.apply_std_ratio(tn, tt, tx), js.apply_std_ratio(jn, jt, jx))


def test_prior_mix_mult_std_inv_rejects_one_source():
    L = torch.ones((1, 1, 1, 4))
    with pytest.raises(ValueError, match="ndim=1"):
        PriorMixSDE.mult_std_inv(L, torch.ones((1, 1, 4)))


@pytest.mark.parametrize("channels", [1, 2])
def test_prior_mix_prior_sampling_with_the_jax_draw(inputs, channels):
    js, ts = JaxPriorMixSDE(), PriorMixSDE()
    x, mix, _, _ = inputs(2)
    cond = mix if channels == 1 else x  # the mixture, or a prior centred on ndim channels
    key = jax.random.PRNGKey(3)
    want = js.prior_sampling(key, jnp.asarray(cond))
    z = np.array(jax.random.normal(key, (B, 2, T), jnp.float32))
    _close(ts.prior_sampling(torch.from_numpy(cond), z=torch.from_numpy(z)), want, QUIET[False])
    drawn = ts.prior_sampling(torch.from_numpy(cond), generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (B, 2, T) and torch.isfinite(drawn).all()
    with pytest.raises(ValueError, match="1 channel or ndim channels"):
        ts.prior_sampling(torch.zeros((1, 3, 8)))


def test_prior_mix_sample_time_varprop():
    js, ts = JaxPriorMixSDE(), PriorMixSDE()
    key = jax.random.PRNGKey(7)
    want = js.sample_time_varprop(key, 64, t_eps=0.03)
    u = np.array(jax.random.uniform(key, (64,)))
    _close(ts.sample_time_varprop(torch.from_numpy(u), t_eps=0.03), want)


@pytest.mark.parametrize("probability_flow", [False, True])
def test_prior_mix_reverse_sde_and_discretize(inputs, probability_flow):
    js, ts = JaxPriorMixSDE(), PriorMixSDE()
    (jx, jm, jt, _), (tx, tm, tt, _) = _both(*inputs(2))
    jscore = lambda x, t, c: jnp.tanh(x) - c
    tscore = lambda x, t, c: torch.tanh(x) - c
    for got, want in zip(reverse_sde(ts, tscore, tx, tt, tm, probability_flow=probability_flow),
                         jbase.reverse_sde(js, jscore, jx, jt, jm, probability_flow=probability_flow)):
        _close(got, want, QUIET[False])
    for got, want in zip(reverse_discretize(ts, tscore, tx, tt, tm, probability_flow=probability_flow),
                         jbase.reverse_discretize(js, jscore, jx, jt, jm, probability_flow=probability_flow)):
        _close(got, want, QUIET[False])


OU_CASES = [(JaxOUVESDE, OUVESDE, {}), (JaxOUVESDE, OUVESDE, dict(theta=0.5, sigma_max=0.8)),
            (JaxOUVPSDE, OUVPSDE, {}), (JaxOUVPSDE, OUVPSDE, dict(beta_max=2.0, stiffness=0.5))]


@pytest.mark.parametrize("jcls,tcls,kw", OU_CASES, ids=lambda v: getattr(v, "__name__", str(v)))
def test_ou_sdes(inputs, jcls, tcls, kw):
    js, ts = jcls(**kw), tcls(**kw)
    x, _, t, _ = inputs(2)
    y = x[:, ::-1].copy()  # the conditioning signal has x's shape
    (jx, jy, jt), (tx, ty, tt) = _both(x, y, t)
    for got, want in zip(ts.sde(tx, tt, ty), js.sde(jx, jt, jy)):
        _close(got, want)
    jmean, jstd = js.marginal_prob(jx, jt, jy)
    tmean, tstd = ts.marginal_prob(tx, tt, ty)
    _close(tmean, jmean)
    _close(tstd, jstd)
    _close(ts.mult_std(tstd, tx), js.mult_std(jstd, jx))
    _close(ts.mult_std_inv(tstd, tx), js.mult_std_inv(jstd, jx))
    for got, want in zip(ts.discretize(tx, tt, ty), js.discretize(jx, jt, jy)):
        _close(got, want)
    key = jax.random.PRNGKey(2)
    z = np.array(jax.random.normal(key, x.shape, jnp.float32))
    _close(ts.prior_sampling(ty, z=torch.from_numpy(z)), js.prior_sampling(key, jy))
    assert ts.prior_sampling(ty, generator=torch.Generator().manual_seed(0)).shape == x.shape
