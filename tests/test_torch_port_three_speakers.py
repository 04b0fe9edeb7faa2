"""Three speakers (``n_speakers=3``) in the port against the JAX package, on
the CPU in float32: the port's counterpart of tests/test_three_speakers.py.

  * ``MixSDE(ndim=3)``: the marginal's mean and std, ``mult_std``,
    ``mult_std_inv`` and the SDE's drift and diffusion within 1e-6 of
    their scale; the inverse undoes the std within 1e-4;
  * the training losses over the 3! source orders: ``training_loss`` of a
    tiny 3-speaker NCSN++ with seeded weights under PIT, the power order,
    a random order and init hacks 5, 6 (one of the six orders drawn) and 7
    (PIT over the orders), with the JAX draws: with a linear score within
    1e-6 of the JAX loss, through the network within 1e-4; the two PIT
    losses that only hack 7 reaches, on their own, within 1e-4;
  * ddim and dpmpp recover three analytic sources from their exact score
    (mean error under 1e-2, as the JAX test holds) and equal the JAX
    samplers' result within 1e-5 of scale;
  * a tiny 3-speaker ``DiffSepModel``: 8 input and 6 output channels, one
    train step's loss within 1e-5 relative and gradient norm within 1e-4
    relative of JAX's, and ``separate`` (reverse_diffusion + ald2 and
    ddim, N=2, with the JAX draws) within 1e-3 of scale (the samplers'
    tolerance in the other port tests).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import jax_loss_draws, jax_pc_noise, jax_score_model, load_port_weights, port_score_model, \
    random_params
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from diffsep_tpu.config import compose as jax_compose
from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel
from diffsep_tpu.sampling import pc_sample as jax_pc_sample
from diffsep_tpu.sde import MixSDE as JaxMixSDE
from diffsep_tpu.train import losses as jax_losses
from diffsep_tpu.train import trainer as jax_trainer
from diffsep_tpu_torch.config import compose
from diffsep_tpu_torch.model import DiffSepModel
from diffsep_tpu_torch.models import layers, state_dict_from_jax
from diffsep_tpu_torch.sampling.pc import pc_sample
from diffsep_tpu_torch.sde import MixSDE
from diffsep_tpu_torch.train import losses

OVERRIDES = ["model.n_speakers=3", "model.score_model.backbone_args.nf=8",
             "model.score_model.backbone_args.ch_mult=[1,2]", "model.score_model.backbone_args.num_res_blocks=1",
             "model.score_model.backbone_args.image_size=64", "model.score_model.backbone_args.dtype=float32",
             "model.score_model.stft_args.n_fft=126", "model.score_model.stft_args.hop_length=32",
             "model.init_hack=5", "model.init_hack_p=0.5", "trainer.accumulate_grad_batches=1"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def test_mixsde_ndim3_closed_forms_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    cond = x.sum(1, keepdims=True)
    t = np.array([0.4, 0.9], np.float32)
    jsde, sde = JaxMixSDE(ndim=3), MixSDE(ndim=3)
    jmean, jL = jsde.marginal_prob(jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    mean, L = sde.marginal_prob(_t(x), _t(t), _t(cond))
    assert mean.shape == x.shape and L.shape == (2, 3, 3)
    assert _rel(mean, jmean) <= 1e-6 and _rel(L, jL) <= 1e-6
    assert _rel(sde.mult_std(L, _t(x)), jsde.mult_std(jL, jnp.asarray(x))) <= 1e-6
    assert _rel(sde.mult_std_inv(L, _t(x)), jsde.mult_std_inv(jL, jnp.asarray(x))) <= 1e-6
    back = sde.mult_std_inv(L, sde.mult_std(L, _t(x)))
    assert float((back - _t(x)).abs().max()) <= 1e-4
    drift, diff = sde.sde(_t(x), _t(t), _t(cond))
    jdrift, jdiff = jsde.sde(jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    assert _rel(drift, jdrift) <= 1e-6 and _rel(diff, jdiff) <= 1e-6
    z = rng.standard_normal((2, 3, 16)).astype(np.float32)
    assert sde.prior_sampling(_t(cond), z=_t(z)).shape == (2, 3, 16)


@pytest.fixture(scope="module")
def net():
    rng = np.random.default_rng(1)
    jm = jax_score_model(num_sources=3)
    params = random_params(jm, rng)
    pm = port_score_model(num_sources=3)
    load_port_weights(pm, params)
    # independent unit-scale draws, as test_torch_port_losses.py takes: a
    # mixture that is the sum of its sources drives these random weights'
    # scores to ~3e3, where the two packages' float32 sums read 1e-5 to
    # 4e-4 apart at two speakers as at three
    mix = rng.standard_normal((4, 1, 1000)).astype(np.float32)
    tgt = rng.standard_normal((4, 3, 1000)).astype(np.float32)
    return jax.jit(jm.apply), params, pm, mix, tgt


# the loss's own arithmetic, with a linear score both packages compute
# alike, within 1e-6 (measured <= 7e-8); through the tiny NCSN++ within 1e-4
# (measured <= 2.6e-5: the network's float32 sums in another order, the
# loss's whitening cancelling most of the score)
SCORE_TOL = {"linear": 1e-6, "net": 1e-4}


@pytest.mark.parametrize("score", sorted(SCORE_TOL))
@pytest.mark.parametrize("init_hack,order", [(False, "pit"), (False, "power"), (False, "random"), (5, "power"),
                                             (6, "power"), (7, "pit")])
def test_training_loss_three_speakers_matches_jax(net, init_hack, order, score):
    japply, params, pm, mix, tgt = net
    key = jax.random.PRNGKey(3)
    kw = dict(t_eps=0.03, init_hack=init_hack, init_hack_p=0.5, train_source_order=order, mmnr_thresh_pit=10.0)
    if score == "net":
        jscore, pscore = (lambda x, t, m: japply({"params": params}, x, t, m)), pm
    else:
        jscore = pscore = lambda x, t, m: -0.5 * x  # noqa: E731
    want = float(jax_losses.training_loss(key, JaxMixSDE(ndim=3), jscore, jnp.asarray(mix), jnp.asarray(tgt), **kw))
    draws = jax_loss_draws(key, tgt.shape, init_hack, order)
    if init_hack == 6:
        assert draws["sel"].max() < 6  # one of the 3! orders
    with torch.no_grad():
        got = float(losses.training_loss(losses.Draws(given=draws), MixSDE(ndim=3), pscore, _t(mix), _t(tgt), **kw))
    assert np.isfinite(got) and abs(got - want) <= SCORE_TOL[score] * abs(want)


@pytest.mark.parametrize("fn", ["allthetime", "init_hack_pit"])
def test_standalone_pit_losses_three_speakers_match_jax(net, fn):
    japply, params, pm, mix, tgt = net
    key = jax.random.PRNGKey(4)
    score = lambda x, t, m: japply({"params": params}, x, t, m)  # noqa: E731
    b = tgt.shape[0]
    if fn == "allthetime":
        want = jax_losses.compute_score_loss_with_pit_allthetime(key, JaxMixSDE(ndim=3), score, jnp.asarray(mix),
                                                                 jnp.asarray(tgt), 0.03)
        kt, kz, ksh = jax.random.split(key, 3)
        draws = {"time": jax.random.uniform(kt, (b,)), "z": jax.random.normal(kz, tgt.shape),
                 "shuffle": jax.random.uniform(ksh, (b, 3))}
        port_fn, args = losses.compute_score_loss_with_pit_allthetime, (0.03,)
    else:
        want = jax_losses.compute_score_loss_init_hack_pit(key, JaxMixSDE(ndim=3), score, jnp.asarray(mix),
                                                           jnp.asarray(tgt))
        draws = {"z0": jax.random.normal(key, tgt.shape)}
        port_fn, args = losses.compute_score_loss_init_hack_pit, ()
    draws = {k: np.array(v) for k, v in draws.items()}
    with torch.no_grad():
        got = port_fn(losses.Draws(given=draws), MixSDE(ndim=3), pm, _t(mix), _t(tgt), *args)
    assert got.shape == (b,)
    assert np.allclose(got.numpy(), np.asarray(want), rtol=SCORE_TOL["net"], atol=0)


@pytest.mark.parametrize("pred", ["ddim", "dpmpp"])
def test_exact_transition_samplers_three_speakers(pred):
    n = 96
    k = np.arange(n)
    x0 = np.stack([np.sin(2 * np.pi * 3 * k / n), 0.7 * np.cos(2 * np.pi * 6 * k / n),
                   0.5 * np.sin(2 * np.pi * 9 * k / n)])[None].astype(np.float32)
    mix = x0.sum(axis=1, keepdims=True)
    jsde, sde = JaxMixSDE(ndim=3, N=6), MixSDE(ndim=3, N=6)

    def jscore(x, t, cond):
        mean, L = jsde.marginal_prob(jnp.asarray(x0), t, cond)
        return -jsde.mult_std_inv(L, jsde.mult_std_inv(L, x - mean))

    def score(x, t, cond):
        mean, L = sde.marginal_prob(_t(x0), t, cond)
        return -sde.mult_std_inv(L, sde.mult_std_inv(L, x - mean))

    key = jax.random.PRNGKey(0)
    want, _ = jax_pc_sample(key, jsde, jscore, jnp.asarray(mix), predictor_name=pred, corrector_name="none")
    got, _ = pc_sample(sde, score, _t(mix), predictor_name=pred, corrector_name="none",
                       noise=jax_pc_noise(key, x0.shape, 6))
    assert float((got - _t(x0)).abs().mean()) < 1e-2
    assert _rel(got, want) <= 1e-5


@pytest.fixture(scope="module")
def models():
    jmodel = JaxDiffSepModel(jax_compose(OVERRIDES))
    params = random_params(jmodel.score_model, np.random.default_rng(5))
    return jmodel, params


def test_three_speaker_model_train_step_matches_jax(models):
    jmodel, params = models
    tmodel = DiffSepModel(compose(OVERRIDES), device="cpu")
    assert tmodel.sde.ndim == 3
    stem = next(m for m in tmodel.score_model.backbone.all_modules if isinstance(m, layers.Conv))
    assert tuple(stem.weight.shape[:2]) == (8, 8)  # the stem takes 2 * 3 + 2 channels
    assert tmodel.score_model.backbone.output_layer.weight.shape[0] == 6
    tmodel.score_model.load_state_dict(state_dict_from_jax(params), strict=True)
    rng = np.random.default_rng(6)
    tgt = (0.3 * rng.standard_normal((2, 3, 800))).astype(np.float32)
    mix = tgt.sum(1, keepdims=True)
    base_key = jax.random.PRNGKey(7)
    state = jax_trainer.init_train_state(params, jmodel.tx, jmodel.clipper)
    key = jax.random.fold_in(base_key, int(state.step))
    _, metrics = jax.jit(jmodel.make_train_step(base_key))(state, jnp.asarray(mix), jnp.asarray(tgt))
    draws = jax_loss_draws(key, tgt.shape, jmodel.loss_cfg.init_hack, jmodel.loss_cfg.train_source_order)
    got = tmodel.make_train_step(seed=0)(tmodel.init_state(), _t(mix), _t(tgt), draws=draws)
    want = float(metrics["train/score_loss"])
    assert abs(float(got["train/score_loss"]) - want) <= 1e-5 * abs(want)
    assert abs(float(got["grad/norm"]) - float(metrics["grad/norm"])) <= 1e-4 * float(metrics["grad/norm"])


@pytest.mark.parametrize("kw", [dict(N=2), dict(N=2, predictor_name="ddim", corrector_name="none", schedule="log")])
def test_three_speaker_separation_matches_jax(models, kw):
    jmodel, params = models
    tmodel = DiffSepModel(compose(OVERRIDES), device="cpu")
    tmodel.score_model.load_state_dict(state_dict_from_jax(params), strict=True)
    mix = (0.3 * np.random.default_rng(8).standard_normal((2, 1, 800))).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want, jnfe = jmodel.separate(params, key, jnp.asarray(mix), **kw)
    got, nfe = tmodel.separate(mix, noise=jax_pc_noise(key, (2, 3, 800), kw["N"]), **kw)
    assert got.shape == (2, 3, 800) and nfe == int(jnfe) and torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-3
