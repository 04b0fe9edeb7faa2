"""The samplers beyond the production pair: diffsep_tpu_torch against
diffsep_tpu (CPU, float32).

Every predictor and corrector, ``denoise=False`` and ``probability_flow``
go through both packages' ``pc_sample`` with the tiny NCSN++ score (seeded
random weights) on MixSDE; the port gets the JAX sampler's own draws
(tests/_torch_port_util.jax_pc_noise). ``ode_sample`` gets the JAX prior
draw. Samples are compared at 1e-3 of their scale, the tolerance of
tests/test_torch_port_sampling.py: each step feeds the previous one's
~1e-5-relative score differences forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    jax_pc_noise, jax_score_model, load_port_weights, one_torch_thread, port_score_model, random_params,
)
from diffsep_tpu.sampling.pc import ode_sample as jax_ode_sample
from diffsep_tpu.sampling.pc import pc_sample as jax_pc_sample
from diffsep_tpu.sde.mixsde import MixSDE as JaxMixSDE
from diffsep_tpu_torch.sampling import get_pc_sampler, ode_sample, pc_sample
from diffsep_tpu_torch.sampling.predictors import DDIMPredictor, DPMpp2MPredictor
from diffsep_tpu_torch.sde import MixSDE

REL = 1e-3
SHAPE = (2, 2, 800)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(4)
    jm = jax_score_model()
    params = random_params(jm, rng)
    tm = port_score_model()
    load_port_weights(tm, params)
    y = (rng.standard_normal((SHAPE[0], 1, SHAPE[2])) * 0.5).astype(np.float32)
    return jm, params, tm, y


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=REL * np.abs(want).max())


# (predictor, corrector, settings, score evaluations per step in the port)
CASES = [
    ("euler_maruyama", "none", {}, 1),
    ("heun", "none", {}, 2),
    ("dpmpp", "none", {}, 1),
    ("dpmpp", "none", {"schedule": "log"}, 1),
    ("reverse_diffusion", "langevin", {}, 2),
    ("reverse_diffusion", "ald", {"corrector_steps": 2}, 3),
    ("reverse_diffusion", "ald2", {"denoise": False}, 2),
    ("euler_maruyama", "ald2", {"probability_flow": True}, 2),
    ("reverse_diffusion", "none", {"probability_flow": True, "schedule": "linear"}, 1),
    ("none", "ald2", {}, 1),
]


@pytest.mark.parametrize("predictor,corrector,settings,evals", CASES,
                         ids=[f"{p}-{c}-{'-'.join(s)}" for p, c, s, _ in CASES])
def test_pc_sample_matches_with_the_jax_noise(models, predictor, corrector, settings, evals):
    jm, params, tm, y = models
    N = 3
    kw = dict(predictor_name=predictor, corrector_name=corrector, N=N, snr=0.3, **settings)
    jscore = lambda x, t, m: jm.apply({"params": params}, x, t, m)
    want, _ = jax.jit(lambda k, y: jax_pc_sample(k, JaxMixSDE(), jscore, y, **kw))(
        jax.random.PRNGKey(5), jnp.asarray(y))
    noise = jax_pc_noise(jax.random.PRNGKey(5), SHAPE, N, settings.get("corrector_steps", 1))
    with torch.no_grad():
        got, nfe = pc_sample(MixSDE(), tm, torch.from_numpy(y), noise=noise, **kw)
    _close(got.numpy(), np.asarray(want))
    assert nfe == N * evals  # the score calls made (JAX counts 1 per predictor step)


def test_intermediate_steps_match(models):
    jm, params, tm, y = models
    kw = dict(predictor_name="reverse_diffusion", corrector_name="ald2", N=2, snr=0.3, intermediate=True)
    jscore = lambda x, t, m: jm.apply({"params": params}, x, t, m)
    want, _, jims = jax.jit(lambda k, y: jax_pc_sample(k, JaxMixSDE(), jscore, y, **kw))(
        jax.random.PRNGKey(6), jnp.asarray(y))
    with torch.no_grad():
        got, _, ims = pc_sample(MixSDE(), tm, torch.from_numpy(y),
                                noise=jax_pc_noise(jax.random.PRNGKey(6), SHAPE, 2), **kw)
    assert ims.shape == (2, 2) + SHAPE
    _close(ims.numpy(), np.asarray(jims))
    assert torch.equal(ims[-1, 1], got)


def test_dpmpp_first_step_is_the_ddim_step(models):
    """With no history the multistep correction is gated off exactly."""
    _, _, tm, y = models
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32))
    y = torch.from_numpy(y)
    t, t_next = torch.full((2,), 0.8), torch.full((2,), 0.5)
    sde = MixSDE()
    with torch.no_grad():
        dpm = DPMpp2MPredictor(sde, tm)
        got, got_mean, state = dpm.update(x, t, y, t_next=t_next, state=dpm.init_state(x))
        want, want_mean = DDIMPredictor(sde, tm).update(x, t, y, t_next=t_next)
        assert torch.equal(got, want) and torch.equal(got_mean, want_mean)
        assert torch.equal(state[0], want_mean) and torch.equal(state[1], t) and state[2].item() == 1.0
        # with history it departs from ddim
        later, _, _ = dpm.update(got, t_next, y, t_next=torch.full((2,), 0.2), state=state)
        plain, _ = DDIMPredictor(sde, tm).update(got, t_next, y, t_next=torch.full((2,), 0.2))
        assert not torch.allclose(later, plain)


@pytest.mark.parametrize("denoise", [True, False])
def test_ode_sample_rk4_matches_with_the_jax_prior(models, denoise):
    jm, params, tm, y = models
    N = 2
    jscore = lambda x, t, m: jm.apply({"params": params}, x, t, m)
    key = jax.random.PRNGKey(9)
    want, jnfe = jax.jit(lambda k, y: jax_ode_sample(k, JaxMixSDE(), jscore, y, N=N, denoise=denoise))(
        key, jnp.asarray(y))
    # MixSDE.prior_sampling draws normal(key, (batch, n_src, n)) directly
    prior = torch.from_numpy(np.asarray(jax.random.normal(key, SHAPE, jnp.float32)))
    with torch.no_grad():
        got, nfe = ode_sample(MixSDE(), tm, torch.from_numpy(y), N=N, denoise=denoise, prior=prior)
    _close(got.numpy(), np.asarray(want))
    assert int(jnfe) == 4 * N and nfe == 4 * N + denoise  # the port counts the denoise step


def test_ode_sample_rk45_runs_on_the_host(models):
    _, _, tm, y = models
    y = torch.from_numpy(y[:1, :, :400])
    with torch.no_grad():
        x, nfe = ode_sample(MixSDE(), tm, y, method="rk45", rtol=1e-2, atol=1e-2,
                            generator=torch.Generator().manual_seed(0))
    assert x.shape == (1, 2, 400) and torch.isfinite(x).all() and nfe > 1
    with pytest.raises(ValueError, match="unknown ODE method"):
        ode_sample(MixSDE(), tm, y, method="euler")


def test_get_pc_sampler_takes_a_generator(models):
    _, _, tm, y = models
    y = torch.from_numpy(y)
    with torch.no_grad():
        sampler = get_pc_sampler("ddim", "none", MixSDE(), tm, y, generator=torch.Generator().manual_seed(1), N=2)
        a, nfe = sampler()
        b, _ = sampler(generator=torch.Generator().manual_seed(1))
        c, _ = sampler(generator=torch.Generator().manual_seed(2))
    assert nfe == 2 and torch.equal(a, b) and not torch.equal(a, c)


def test_ald_needs_the_mixing_sde(models):
    from diffsep_tpu_torch.sampling.correctors import CORRECTORS
    from diffsep_tpu_torch.sde.base import SDE

    with pytest.raises(NotImplementedError, match="'ald'"):
        CORRECTORS["ald"](SDE(), None, snr=0.1, n_steps=1)
