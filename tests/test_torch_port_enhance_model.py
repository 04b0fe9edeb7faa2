"""The enhancement recipe's model and samplers: diffsep_tpu_torch against
diffsep_tpu on the CPU, in float32.

* the composed ``experiment=noise-reduction`` tree is the JAX package's,
  apart from the ``_target_`` prefixes;
* the samplers that accept PriorMixSDE (reverse_diffusion + ald2, ddim +
  none, dpmpp + none) on the tiny NCSN++ score with seeded random weights
  and the JAX sampler's own draws (tests/_torch_port_util.jax_pc_noise),
  at 1e-3 of scale, the tolerance of tests/test_torch_port_sampling.py;
* ``DiffSepModel.separate`` of the recipe on a 1-channel noisy input (the
  prior's c == 1 branch), end to end, at the same tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    JAX_TINY_OVERRIDES, jax_pc_noise, jax_score_model, load_port_weights, one_torch_thread, port_score_model,
    random_params,
)
from diffsep_tpu.config import compose as jax_compose
from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel
from diffsep_tpu.sampling.pc import pc_sample as jax_pc_sample
from diffsep_tpu.sde.mixsde import PriorMixSDE as JaxPriorMixSDE
from diffsep_tpu_torch.config import compose
from diffsep_tpu_torch.config.compose import to_dict
from diffsep_tpu_torch.model import DiffSepModel, _build_sde
from diffsep_tpu_torch.models import state_dict_from_jax
from diffsep_tpu_torch.sampling import pc_sample
from diffsep_tpu_torch.sde import OUVESDE, OUVPSDE, MixSDE, PriorMixSDE

REL = 1e-3
SHAPE = (2, 2, 1600)
NR_TINY = ["experiment=noise-reduction"] + JAX_TINY_OVERRIDES[1:]


def _strip_targets(node):
    """The tree with each ``_target_`` reduced to its class name."""
    if isinstance(node, dict):
        return {k: v.rpartition(".")[2] if k == "_target_" else _strip_targets(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_strip_targets(v) for v in node]
    return node


def test_compose_noise_reduction_is_the_jax_tree():
    from diffsep_tpu.config.compose import to_dict as jax_to_dict

    want = jax_to_dict(jax_compose(["experiment=noise-reduction"]))
    got = to_dict(compose(["experiment=noise-reduction"]))
    # the trainer runs on one GPU, not one TPU chip: the one key that differs
    assert (want["trainer"].pop("accelerator"), got["trainer"].pop("accelerator")) == ("tpu", "gpu")
    assert _strip_targets(got) == _strip_targets(want)
    assert got["name"] == "enhancement" and got["model"]["sde"]["_target_"] == "diffsep_tpu_torch.sde.PriorMixSDE"
    assert got["model"]["val_losses"]["val/pesq"]["_target_"] == "diffsep_tpu_torch.models.losses.PESQ"
    assert got["datamodule"]["train"]["dataset"]["_target_"] == "diffsep_tpu_torch.data.NoisyDataset"


@pytest.mark.parametrize("target,cls", [("diffsep_tpu_torch.sde.MixSDE", MixSDE),
                                        ("diffsep_tpu_torch.sde.PriorMixSDE", PriorMixSDE),
                                        ("OUVESDE", OUVESDE), ("sdes.sdes.OUVPSDE", OUVPSDE)])
def test_build_sde_by_target(target, cls):
    sde = _build_sde({"n_speakers": 3, "sde": {"_target_": target, "N": 7, "sigma_min": 0.1, "ndim": 2}})
    # the config's values of the SDE's own fields (FLAGSHIP's MixSDE keys
    # reach every config through the merge, so the others are dropped)
    assert type(sde) is cls and sde.N == 7 and getattr(sde, "sigma_min", 0.1) == 0.1
    if hasattr(sde, "ndim"):
        assert sde.ndim == 3  # the number of sources, as ${model.n_speakers} interpolates it
    with pytest.raises(NotImplementedError, match="sde"):
        _build_sde({"n_speakers": 2, "sde": {"_target_": "sdes.sdes.OtherSDE"}})


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(6)
    jm = jax_score_model()
    params = random_params(jm, rng)
    tm = port_score_model()
    load_port_weights(tm, params)
    y = (rng.standard_normal((SHAPE[0], 1, SHAPE[2])) * 0.5).astype(np.float32)
    y[:, :, 600:1100] *= 0.02  # a quiet stretch: the envelope varies
    return jm, params, tm, y


CASES = [("reverse_diffusion", "ald2", {}), ("ddim", "none", {}), ("dpmpp", "none", {}),
         ("dpmpp", "none", {"schedule": "log"})]


@pytest.mark.parametrize("predictor,corrector,settings", CASES,
                         ids=[f"{p}-{c}-{'-'.join(s)}" for p, c, s in CASES])
def test_samplers_on_prior_mix_sde(models, predictor, corrector, settings):
    jm, params, tm, y = models
    N = 3
    kw = dict(predictor_name=predictor, corrector_name=corrector, N=N, snr=0.3, **settings)
    jscore = lambda x, t, m: jm.apply({"params": params}, x, t, m)
    want, jnfe = jax.jit(lambda k, y: jax_pc_sample(k, JaxPriorMixSDE(), jscore, y, **kw))(
        jax.random.PRNGKey(9), jnp.asarray(y))
    noise = jax_pc_noise(jax.random.PRNGKey(9), SHAPE, N)
    with torch.no_grad():
        got, nfe = pc_sample(PriorMixSDE(), tm, torch.from_numpy(y), noise=noise, **kw)
    want = np.asarray(want)
    assert got.shape == want.shape and nfe == int(jnfe)
    np.testing.assert_allclose(got.numpy(), want, atol=REL * np.abs(want).max())


def test_ald_refuses_prior_mix_sde(models):
    with pytest.raises(NotImplementedError, match="'ald'"):
        pc_sample(PriorMixSDE(), models[2], torch.zeros(1, 1, 64), corrector_name="ald", N=1)


def test_recipe_separate_matches(rng):
    """The recipe's model and sampler (reverse_diffusion + ald2) on noisy
    1-channel inputs, through separate (normalize, sample, denormalize)."""
    jmodel = JaxDiffSepModel(jax_compose(NR_TINY))
    params = random_params(jmodel.score_model, np.random.default_rng(2))
    tmodel = DiffSepModel(compose(NR_TINY), device="cpu")
    tmodel.score_model.load_state_dict(state_dict_from_jax(params), strict=True)
    assert isinstance(tmodel.sde, PriorMixSDE) and tmodel.config["fs"] == 16000
    assert tmodel.loss_cfg.init_hack == 4 and tmodel.loss_cfg.train_source_order == "None"
    noisy = (rng.standard_normal((2, 1, 1600)) * 0.3 + 0.05).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want, jnfe = jmodel.separate(params, key, jnp.asarray(noisy), N=2)
    want = np.asarray(want)
    got, nfe = tmodel.separate(torch.from_numpy(noisy), noise=jax_pc_noise(key, (2, 2, 1600), 2), N=2)
    assert nfe == int(jnfe) and got.shape == want.shape == (2, 2, 1600)
    np.testing.assert_allclose(got.numpy(), want, atol=REL * np.abs(want).max())
