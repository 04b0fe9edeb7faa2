"""Masked normalization, DiffSepModel.separate_masked and get_pc_sampler:
diffsep_tpu_torch against diffsep_tpu on the CPU in float32.

The statistics are compared at 1e-6 (both compute them in float32 or on the
host in float64); separate_masked gets the JAX sampler's draws and its
estimates agree at 1e-3 of their scale, the tolerance of
tests/test_torch_port_sampling.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import JAX_TINY_OVERRIDES, PORT_TINY_CONFIG, jax_pc_noise, random_params
from diffsep_tpu.config import compose
from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel
from diffsep_tpu.train import losses as jax_losses
from diffsep_tpu_torch.model import DiffSepModel
from diffsep_tpu_torch.models import state_dict_from_jax
from diffsep_tpu_torch.train import losses

REL = 1e-3
STATS_TOL = 1e-6


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxDiffSepModel(compose(JAX_TINY_OVERRIDES))
    params = random_params(jmodel.score_model, np.random.default_rng(13))
    tmodel = DiffSepModel(PORT_TINY_CONFIG, device="cpu")
    tmodel.score_model.load_state_dict(state_dict_from_jax(params), strict=True)
    return jmodel, params, tmodel


@pytest.mark.parametrize("lengths", [(1600,), (1, 700, 1234), (2, 3000)])
def test_normalize_rows_host_matches(lengths):
    rng = np.random.default_rng(sum(lengths))
    rows = [(rng.standard_normal((1, n)) * 0.2 + 0.05).astype(np.float32) for n in lengths]
    padded = 3000
    got = losses.normalize_rows_host(rows, padded)
    want = jax_losses.normalize_rows_host(rows, padded)
    for g, w in zip(got[0], want[0]):
        assert g.shape == w.shape == (1, padded) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=STATS_TOL)
    np.testing.assert_allclose(got[1], want[1], atol=STATS_TOL)
    np.testing.assert_allclose(got[2], want[2], atol=STATS_TOL)
    if lengths[0] == 1:
        assert got[2][0] == 1.0  # one sample: std 1, not the NaN of ddof=1


@pytest.mark.parametrize("n_valid", [[1000, 400, 1], [0, 1000, 5000], [1000, 1000, 1000]],
                         ids=["short", "clamped", "full"])
def test_normalize_batch_masked_matches(n_valid):
    rng = np.random.default_rng(2)
    mix = (rng.standard_normal((3, 1, 1000)) * 0.3 + 0.1).astype(np.float32)
    got = losses.normalize_batch_masked(torch.from_numpy(mix), torch.tensor(n_valid))
    want = jax_losses.normalize_batch_masked(jnp.asarray(mix), jnp.asarray(n_valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=STATS_TOL)
    n = np.clip(n_valid, 1, 1000)
    for b in range(3):
        assert (got[0][b, :, n[b]:] == 0).all()


def test_normalize_batch_masked_at_full_length_is_normalize_batch():
    mix = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 1, 500)).astype(np.float32))
    (want, _), mean, std = losses.normalize_batch(mix)
    got, gmean, gstd = losses.normalize_batch_masked(mix, torch.tensor([500, 500]))
    torch.testing.assert_close(got, want, atol=STATS_TOL, rtol=0)
    torch.testing.assert_close(gstd, std, atol=STATS_TOL, rtol=0)
    torch.testing.assert_close(gmean, mean, atol=STATS_TOL, rtol=0)


@pytest.mark.parametrize("n_valid", [[1000, 650], [0, 4000]], ids=["padded", "clamped"])
def test_separate_masked_matches(pair, n_valid):
    jmodel, params, tmodel = pair
    rng = np.random.default_rng(5)
    mix = (rng.standard_normal((2, 1, 1000)) * 0.3 + 0.1).astype(np.float32)
    mix[1, :, 650:] = 0.0  # a zero-padded request
    key = jax.random.PRNGKey(17)
    kw = dict(N=2)
    want, jnfe = jmodel.separate_masked(params, key, jnp.asarray(mix), jnp.asarray(n_valid), **kw)
    want = np.asarray(want)
    got, nfe = tmodel.separate_masked(torch.from_numpy(mix), n_valid,
                                      noise=jax_pc_noise(key, (2, 2, 1000), 2), **kw)
    assert nfe == int(jnfe) and got.shape == want.shape == (2, 2, 1000)
    np.testing.assert_allclose(got.numpy(), want, atol=REL * np.abs(want).max())
    n = np.clip(n_valid, 1, 1000)
    for b in range(2):
        assert (got[b, :, n[b]:] == 0).all()


def test_get_pc_sampler_minibatch_runs_the_chunks_in_turn(pair):
    """minibatch=2 on 3 rows: the chunks (2 rows, then 1) are sampled one
    after the other from the one generator; nfe comes per chunk."""
    _, _, tmodel = pair
    y = torch.from_numpy(np.random.default_rng(9).standard_normal((3, 1, 600)).astype(np.float32))
    got, nfes = tmodel.get_pc_sampler("ddim", "none", y, generator=torch.Generator().manual_seed(3), N=3,
                                      minibatch=2)()
    gen = torch.Generator().manual_seed(3)
    parts = [tmodel.get_pc_sampler("ddim", "none", y[i:i + 2], generator=gen, N=3)() for i in (0, 2)]
    assert nfes == [nfe for _, nfe in parts] == [3, 3]
    torch.testing.assert_close(got, torch.cat([x for x, _ in parts]), atol=0, rtol=0)


def test_get_pc_sampler_runs_without_autograd_in_any_thread(pair):
    """Grad mode is per thread and on in a new one: the callable turns it off
    itself, as the HTTP front end's batcher thread needs."""
    import threading

    _, _, tmodel = pair
    y = torch.from_numpy(np.random.default_rng(10).standard_normal((1, 1, 600)).astype(np.float32))
    sampler = tmodel.get_pc_sampler("ddim", "none", y, generator=torch.Generator().manual_seed(0), N=3)
    out = {}
    worker = threading.Thread(target=lambda: out.update(x=sampler()[0], grad=torch.is_grad_enabled()))
    worker.start()
    worker.join()
    assert out["grad"] and not out["x"].requires_grad


def test_separate_masked_at_full_length_is_separate(pair):
    _, _, tmodel = pair
    mix = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 1, 800)).astype(np.float32))
    noise = {"prior": torch.from_numpy(np.random.default_rng(7).standard_normal((1, 2, 800)).astype(np.float32))}
    kw = dict(predictor_name="ddim", corrector_name="none", N=3)
    a, _ = tmodel.separate(mix, noise=noise, **kw)
    b, _ = tmodel.separate_masked(mix, [800], noise=noise, **kw)
    torch.testing.assert_close(b, a, atol=1e-5, rtol=0)
