"""diffsep_tpu_torch pc_sample vs diffsep_tpu pc_sample (CPU, float32).

Both run the tiny NCSN++ score (seeded random weights) on MixSDE; the port
gets the JAX sampler's own standard-normal draws (tests/_torch_port_util.
jax_pc_noise). Each step feeds the previous one's ~1e-5-relative score
differences forward, so samples are compared at 1e-3 of their scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import (
    jax_pc_noise, jax_score_model, load_port_weights, port_score_model, random_params,
)
from diffsep_tpu.sampling.pc import make_timesteps as jax_make_timesteps
from diffsep_tpu.sampling.pc import pc_sample as jax_pc_sample
from diffsep_tpu.sde.mixsde import MixSDE as JaxMixSDE
from diffsep_tpu_torch.sampling import make_timesteps, pc_sample
from diffsep_tpu_torch.sde import MixSDE

REL = 1e-3


@pytest.mark.parametrize("schedule", [None, "linear", "log", "revlog"])
def test_make_timesteps_matches(schedule):
    jts, jdts = jax_make_timesteps(1.0, 0.03, 7, schedule)
    ts, dts = make_timesteps(1.0, 0.03, 7, schedule)
    np.testing.assert_allclose(ts, np.asarray(jts), rtol=1e-6)
    np.testing.assert_allclose(dts, np.asarray(jdts), rtol=1e-5)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(2)
    jm = jax_score_model()
    params = random_params(jm, rng)
    tm = port_score_model()
    load_port_weights(tm, params)
    return jm, params, tm


@pytest.mark.parametrize(
    "predictor,corrector,N,schedule",
    [("ddim", "none", 3, None), ("reverse_diffusion", "ald2", 2, "log")],
)
def test_pc_sample_matches_with_the_jax_noise(models, rng, predictor, corrector, N, schedule):
    jm, params, tm = models
    y = (rng.standard_normal((2, 1, 1000)) * 0.5).astype(np.float32)
    key = jax.random.PRNGKey(7)
    kw = dict(predictor_name=predictor, corrector_name=corrector, N=N, snr=0.5,
              schedule=schedule)

    jscore = lambda x, t, m: jm.apply({"params": params}, x, t, m)
    run = jax.jit(lambda k, y: jax_pc_sample(k, JaxMixSDE(), jscore, y, **kw))
    want, jnfe = run(key, jnp.asarray(y))
    want = np.asarray(want)

    noise = jax_pc_noise(key, (2, 2, 1000), N)
    with torch.no_grad():
        got, nfe = pc_sample(MixSDE(), tm, torch.from_numpy(y), noise=noise, **kw)
    assert nfe == int(jnfe) == N * (2 if corrector == "ald2" else 1)
    assert got.shape == want.shape == (2, 2, 1000)
    np.testing.assert_allclose(got.numpy(), want, atol=REL * np.abs(want).max())


def test_pc_sample_draws_from_a_generator(models, rng):
    _, _, tm = models
    y = torch.from_numpy((rng.standard_normal((1, 1, 600)) * 0.5).astype(np.float32))
    with torch.no_grad():
        a, _ = pc_sample(MixSDE(), tm, y, N=2, generator=torch.Generator().manual_seed(0))
        b, _ = pc_sample(MixSDE(), tm, y, N=2, generator=torch.Generator().manual_seed(0))
        c, _ = pc_sample(MixSDE(), tm, y, N=2, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()
