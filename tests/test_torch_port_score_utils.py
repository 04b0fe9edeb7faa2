"""The port's score_utils (models/score_utils.py) against the JAX
package's, on the CPU: the registry, the numpy schedules (equal bit for
bit) and get_score_fn under OUVE and OUVP, continuous and discrete, with the
same network on both sides (float32, within 1e-6 of scale)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsep_tpu.models import score_utils as J
from diffsep_tpu.sde import OUVESDE as JOUVE
from diffsep_tpu.sde import OUVPSDE as JOUVP
from diffsep_tpu_torch.models import score_utils as P
from diffsep_tpu_torch.sde import MixSDE
from diffsep_tpu_torch.sde.ouve import OUVESDE, OUVPSDE

TOL = 1e-6


def test_register_and_get_model():
    @P.register_model(name="toy_port")
    class Toy:
        pass

    @P.register_model
    class Toy2:
        pass

    assert P.get_model("toy_port") is Toy and P.get_model("Toy2") is Toy2
    with pytest.raises(ValueError, match="toy_port"):
        P.get_model("missing")


@pytest.mark.parametrize("args", [(0.01, 1.0, 5), (0.05, 0.5, 30), (1e-3, 50.0, 232)])
def test_get_sigmas_equals_jax(args):
    np.testing.assert_array_equal(P.get_sigmas(*args), J.get_sigmas(*args))


@pytest.mark.parametrize("args", [(0.1, 20.0, 1000), (0.01, 1.0, 100)])
def test_get_ddpm_params_equals_jax(args):
    want, got = J.get_ddpm_params(*args), P.get_ddpm_params(*args)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _net(np_like):
    """The same toy network in either framework: x * (1 + 0.1 labels)."""
    def model_fn(x, labels):
        return x * (1.0 + 0.1 * labels[:, None, None])
    return model_fn


SDES = {
    "ouve": (lambda: JOUVE(theta=1.5, sigma_min=0.05, sigma_max=0.5, N=100),
             lambda: OUVESDE(theta=1.5, sigma_min=0.05, sigma_max=0.5, N=100)),
    "ouvp": (lambda: JOUVP(beta_min=0.01, beta_max=1.0, stiffness=1.0, N=100),
             lambda: OUVPSDE(beta_min=0.01, beta_max=1.0, stiffness=1.0, N=100)),
}


@pytest.mark.parametrize("continuous", [True, False])
@pytest.mark.parametrize("kind", sorted(SDES))
def test_score_fn_matches_jax(kind, continuous):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2, 16)).astype(np.float32)
    y = rng.standard_normal((3, 1, 16)).astype(np.float32)
    t = np.array([0.05, 0.37, 0.9], np.float32)
    make_jax, make_port = SDES[kind]
    want = np.asarray(J.get_score_fn(make_jax(), _net(jnp), continuous)(jnp.asarray(x), jnp.asarray(t),
                                                                           jnp.asarray(y)))
    got = P.get_score_fn(make_port(), _net(torch), continuous)(torch.from_numpy(x), torch.from_numpy(t),
                                                                 torch.from_numpy(y)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())


def test_score_fn_discrete_ouve_labels_are_rounded_steps():
    seen = {}

    def model_fn(x, labels):
        seen["labels"] = labels
        return x

    sde = OUVESDE(N=11)
    P.get_score_fn(sde, model_fn)(torch.zeros(2, 1, 4), torch.tensor([0.0, 0.55]))
    assert seen["labels"].tolist() == [10.0, 4.0]  # round-half-to-even of 4.5


def test_score_fn_rejects_mix_sde():
    with pytest.raises(NotImplementedError):
        P.get_score_fn(MixSDE(), lambda x, labels: x)
