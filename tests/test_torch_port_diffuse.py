"""The DiffuSE model family (``model=diffuse``) of diffsep_tpu_torch against
diffsep_tpu, on the CPU in float32.

Every parameter is randomized (seeded numpy values of unit scale, the
zero-initialized output projection included: a fresh DiffuSE returns
exactly 0 in both packages, and a comparison of zeros would pass whatever
the network did) and carried across with ``diffuse_state_dict_from_jax``
(``strict=True``). Tolerances:
  * the step embedding within 1e-6 of its scale, on a time grid with the
    rows the table clamps (t >= 0.98) and on integer steps; its sinusoid
    table bit for bit;
  * the backbone's output within 1e-5 of its scale, at an even and an odd
    length;
  * parameter gradients within 1e-4 of the gradient norm (max |difference|
    over the global L2 norm);
  * ``DiffSepModel``: its settings equal the JAX model's; one train step's
    loss within 1e-5 relative, its gradient norm within 1e-4; ``separate``
    within 1e-3 of scale, the samplers' tolerance in the other port tests
    (each step feeds the score's ~1e-6 differences forward).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import jax_loss_draws, jax_pc_noise, random_params
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from diffsep_tpu.config import compose as jax_compose
from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel
from diffsep_tpu.models.cdiffuse import DiffuSE as JaxDiffuSE
from diffsep_tpu.models.cdiffuse import DiffusionEmbedding as JaxEmbedding
from diffsep_tpu.train import trainer as jax_trainer
from diffsep_tpu_torch.config import compose
from diffsep_tpu_torch.model import DiffSepModel
from diffsep_tpu_torch.models import DiffuSE, ScoreModelDiffuSE, diffuse_state_dict_from_jax
from diffsep_tpu_torch.models.cdiffuse import DiffusionEmbedding

TINY = dict(residual_layers=4, residual_channels=8, dilation_cycle_length=3)
OVERRIDES = ["model=diffuse"] + [f"model.score_model.backbone_args.{k}={v}" for k, v in TINY.items()]
# the continuous times of the samplers (t = T = 1 first) and the rows that
# ceil(t * 50) = 50 reaches, clamped to the last one
TIMES = [1.0, 0.999, 0.99, 0.98, 0.975, 0.5, 0.123, 0.03, 0.0]
STEPS = [0, 1, 17, 48, 49]


def _fill(tree, rng):
    """A param tree's shapes filled with seeded values of unit scale (fan-in
    scaled weights, 0.1-scale biases)."""
    def leaf(path, x):
        if len(x.shape) >= 2:
            return (rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))).astype(np.float32)
        return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def embedding():
    jm = JaxEmbedding(50)
    params = _fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.ones((1,)))["params"],
                   np.random.default_rng(1))
    tm = DiffusionEmbedding(50)
    sd = diffuse_state_dict_from_jax({"diffusion_embedding": params})
    tm.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    return jm, params, tm


@pytest.mark.parametrize("kind", ["continuous", "integer"])
def test_diffusion_embedding_matches_jax(embedding, kind):
    jm, params, tm = embedding
    t = np.asarray(TIMES, np.float32) if kind == "continuous" else np.asarray(STEPS, np.int32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(t)))
    with torch.no_grad():
        got = tm(torch.from_numpy(t)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    table = np.asarray(jm.apply({"params": params}, jnp.ones((1,)), method=lambda m, t: m.table))
    assert np.array_equal(tm.table.numpy(), table)


def test_time_one_takes_the_last_row(embedding):
    """t >= 0.98 clamps both rows to the table's last, as the JAX gather
    does: the embedding of t = 1 is step 49's."""
    _, _, tm = embedding
    with torch.no_grad():
        top = tm(torch.tensor([49]))
        for t in (1.0, 0.99, 0.98):
            assert torch.equal(tm(torch.tensor([t])), top)


@pytest.fixture(scope="module")
def backbone():
    jm = JaxDiffuSE(num_channels_in=2, num_channels_out=2, **TINY)
    x = jnp.zeros((1, 2, 64))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, jnp.ones((1,)), x[:, :1])["params"]
    params = _fill(shapes, np.random.default_rng(2))
    tm = DiffuSE(2, 2, **TINY)
    tm.load_state_dict(diffuse_state_dict_from_jax(params), strict=True)
    return jm, params, tm


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 2, n)).astype(np.float32)
    y = rng.standard_normal((2, 1, n)).astype(np.float32)
    return x, np.asarray([0.37, 1.0], np.float32), y


@pytest.mark.parametrize("n", [512, 517])
def test_diffuse_forward_matches_jax(backbone, n):
    jm, params, tm = backbone
    x, t, y = _inputs(n, n)
    want = np.asarray(jm.apply({"params": params}, x, t, y))
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (x, t, y))).numpy()
    assert got.shape == want.shape == (2, 2, n)
    assert np.abs(want).max() > 0.1
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_diffuse_gradients_match_jax(backbone):
    jm, params, tm = backbone
    x, t, y = _inputs(300, 7)
    w = np.random.default_rng(8).standard_normal((2, 2, 300)).astype(np.float32)
    grads = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, x, t, y) * w))(params)
    want = {k: v.numpy() for k, v in diffuse_state_dict_from_jax(grads).items()}
    tm.zero_grad()
    (tm(*map(torch.from_numpy, (x, t, y))) * torch.from_numpy(w)).sum().backward()
    # the last block's residual conv feeds nothing: JAX's gradient is 0,
    # torch leaves it None
    unused = {k for k, p in tm.named_parameters() if p.grad is None}
    assert unused == {f"residual_layers.{TINY['residual_layers'] - 1}.output_residual.{n}" for n in ("weight", "bias")}
    assert all(not want[k].any() for k in unused)
    assert all(np.abs(v).max() > 0 for k, v in want.items() if k not in unused)
    got = {k: p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
           for k, p in tm.named_parameters()}
    assert got.keys() == want.keys()
    norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in want.values()))
    worst = max(np.abs(got[k] - want[k]).max() for k in want)
    assert worst <= 1e-4 * norm


def test_fresh_models_score_exactly_zero():
    """The zero-initialized output projection: both packages' fresh models
    return 0, which is why every other test randomizes all parameters."""
    jmodel = JaxDiffSepModel(jax_compose(OVERRIDES))
    x, t, y = _inputs(256, 9)
    params = jmodel.init_params(jax.random.PRNGKey(0), jnp.asarray(y), jnp.asarray(x))
    assert not np.asarray(jmodel.score_apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))).any()
    tmodel = DiffSepModel(compose(OVERRIDES), device="cpu")
    with torch.no_grad():
        assert not tmodel.score_fn(*map(torch.from_numpy, (x, t, y))).any()
    assert isinstance(tmodel.score_model, ScoreModelDiffuSE)


# keys the JAX DiffSepModel reads with a default: the model node as composed,
# and with these left out (the defaults must agree too)
OPTIONAL = ("init_hack", "init_hack_p", "t_rev_init", "train_source_order", "mmnr_thresh_pit",
            "time_sampling_strategy", "ema_decay", "valid_max_sep_batches", "sampler", "lr_warmup",
            "scheduler", "val_losses")


@pytest.mark.parametrize("node", ["as composed", "defaults"])
def test_settings_match_jax(node):
    jcfg, tcfg = jax_compose(OVERRIDES), compose(OVERRIDES)
    if node == "defaults":
        for cfg in (jcfg, tcfg):
            for k in OPTIONAL:
                cfg.model.pop(k, None)
    jmodel, tmodel = JaxDiffSepModel(jcfg), DiffSepModel(tcfg, device="cpu")
    assert dataclasses.asdict(tmodel.loss_cfg) == dataclasses.asdict(jmodel.loss_cfg)
    assert dataclasses.asdict(tmodel.optim_cfg) == dataclasses.asdict(jmodel.optim_cfg)
    assert tmodel.t_eps == jmodel.t_eps == 0.03
    assert tmodel.sampler_kwargs == jmodel.sampler_kwargs
    assert tmodel.valid_max_sep_batches == jmodel.valid_max_sep_batches
    assert set(tmodel.val_losses) == set(jmodel.val_losses)
    for k in ("N", "ndim", "d_lambda", "sigma_min", "sigma_max"):
        assert getattr(tmodel.sde, k) == getattr(jmodel.sde, k)
    assert type(tmodel.sde).__name__ == type(jmodel.sde).__name__ == "MixSDE"
    assert tmodel.config["loss"]["_target_"] == jcfg.model.loss["_target_"] == "mse"
    # no NCSN++ default reaches the DiffuSE config
    assert "stft_args" not in tmodel.config["score_model"]
    assert set(tmodel.config["score_model"]["backbone_args"]) == set(jcfg.model.score_model.backbone_args)


def test_full_width_matches_the_jax_parameter_tree():
    """model=diffuse as published (30 x 64, embedding 50): the same
    parameter count and shapes as the JAX model's, 3.05M."""
    jmodel = JaxDiffSepModel(jax_compose(["model=diffuse"]))
    x = jnp.zeros((1, 2, 64))
    shapes = jax.eval_shape(jmodel.score_model.init, jax.random.PRNGKey(0), x, jnp.ones((1,)), x[:, :1])["params"]
    want = {k: tuple(v.shape) for k, v in diffuse_state_dict_from_jax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    tmodel = DiffSepModel(compose(["model=diffuse"]), device="cpu")
    got = {k: tuple(v.shape) for k, v in tmodel.score_model.state_dict().items()}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == 3050114


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxDiffSepModel(jax_compose(OVERRIDES + ["trainer.accumulate_grad_batches=1"]))
    params = random_params(jmodel.score_model, np.random.default_rng(3))
    tmodel = DiffSepModel(compose(OVERRIDES + ["trainer.accumulate_grad_batches=1"]), device="cpu")
    tmodel.score_model.load_state_dict(diffuse_state_dict_from_jax(params), strict=True)
    return jmodel, params, tmodel


def test_train_step_matches_jax(pair):
    jmodel, params, shared = pair
    # the step updates the model's parameters in place: a copy of its own
    tmodel = DiffSepModel(compose(OVERRIDES + ["trainer.accumulate_grad_batches=1"]), device="cpu")
    tmodel.score_model.load_state_dict(shared.score_model.state_dict(), strict=True)
    rng = np.random.default_rng(5)
    mix = (0.3 * rng.standard_normal((3, 1, 700))).astype(np.float32)
    tgt = (0.2 * rng.standard_normal((3, 2, 700))).astype(np.float32)
    base_key = jax.random.PRNGKey(6)
    state = jax_trainer.init_train_state(params, jmodel.tx, jmodel.clipper)
    key = jax.random.fold_in(base_key, int(state.step))
    _, metrics = jax.jit(jmodel.make_train_step(base_key))(state, jnp.asarray(mix), jnp.asarray(tgt))
    draws = jax_loss_draws(key, tgt.shape, jmodel.loss_cfg.init_hack, jmodel.loss_cfg.train_source_order)
    pstate = tmodel.init_state()
    got = tmodel.make_train_step(seed=0)(pstate, torch.from_numpy(mix), torch.from_numpy(tgt), draws=draws)
    want_loss = float(metrics["train/score_loss"])
    assert abs(got["train/score_loss"].item() - want_loss) <= 1e-5 * abs(want_loss)
    assert abs(float(got["grad/norm"]) - float(metrics["grad/norm"])) <= 1e-4 * float(metrics["grad/norm"])
    assert pstate.step == 1 and pstate.optimizer.count == 1


SAMPLERS = {
    "ddim+none": dict(predictor_name="ddim", corrector_name="none", N=2),
    "reverse_diffusion+ald2": dict(N=2),
}


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_separate_matches_jax(pair, sampler):
    jmodel, params, tmodel = pair
    kw = SAMPLERS[sampler]
    mix = (np.random.default_rng(10).standard_normal((2, 1, 900)) * 0.3 + 0.05).astype(np.float32)
    key = jax.random.PRNGKey(12)
    want, jnfe = jmodel.separate(params, key, jnp.asarray(mix), **kw)
    want = np.asarray(want)
    got, nfe = tmodel.separate(torch.from_numpy(mix), noise=jax_pc_noise(key, (2, 2, 900), kw["N"]), **kw)
    assert nfe == int(jnfe)
    assert got.shape == want.shape == (2, 2, 900)
    assert np.abs(got.numpy() - want).max() <= 1e-3 * np.abs(want).max()
