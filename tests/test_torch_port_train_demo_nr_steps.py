"""Two steps of the port's enhancement learning demo
(scripts/torch_port_train_demo_nr.py: ``train``) against the JAX script's
loop (scripts/train_demo_nr.py), on the CPU in float32 at reduced width: nf 8,
batch 2 x 2000 samples, the demo's data stream from seed 0. The recipe is
PriorMixSDE with init_hack 4, whose prior pins a 1 / N share of the rows to
t = T from the noisy input: the first trained-step check of that branch.
The JAX init (``init_state(PRNGKey(0), ...)``) is carried across with
``state_dict_from_jax``; the port's steps take the draws of the JAX step
(``fold_in(PRNGKey(1), step)``, init hack 4's row selection among them).
Tolerances: each loss within 1e-5 relative; the EMA's change since the init
within 1e-3 of its norm, against the JAX state carried across with
``train_state_from_jax``, without the attention key biases (NIN_1.b, whose
gradient is rounding: see tests/test_torch_port_train_step.py). At batch 2
these draws pin no row to t = T (each row with probability 1 / 30), so one
more step, at batch 16 with the draws of the JAX step's second key, pins
one, within the same 1e-5.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port_util import jax_loss_draws, load_script
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from diffsep_tpu.config import compose as jax_compose
from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel
from diffsep_tpu_torch.models import state_dict_from_jax, train_state_from_jax

SEED, NF, B, N = 0, 8, 2, 2000


@pytest.fixture(scope="module")
def trained():
    jax_demo, port = load_script("train_demo_nr"), load_script("torch_port_train_demo_nr")
    jmodel = JaxDiffSepModel(jax_compose(port.nr_overrides("float32", False, nf=NF)))
    rng = np.random.default_rng(SEED)
    mix, tgt = jax_demo.make_batch(rng, B, N)
    state0 = jmodel.init_state(jax.random.PRNGKey(SEED), jnp.asarray(mix), jnp.asarray(tgt))
    base_key = jax.random.PRNGKey(1000 * SEED + 1)
    step_fn = jax.jit(jmodel.make_train_step(base_key))
    state, losses = state0, []
    for _ in range(2):
        mix, tgt = jax_demo.make_batch(rng, B, N)
        state, metrics = step_fn(state, jnp.asarray(mix), jnp.asarray(tgt))
        losses.append(float(metrics["train/score_loss"]))

    pmodel = port.build_model("float32", False, "cpu", seed=SEED, nf=NF)
    pmodel.score_model.load_state_dict(state_dict_from_jax(state0.params), strict=True)
    draws = [jax_loss_draws(jax.random.fold_in(base_key, i), (B, 2, N), 4, "None") for i in range(2)]
    run = port.train(pmodel, SEED, 2, np.random.default_rng(SEED), B, N, log=lambda _: None,
                     draws=lambda i: draws[i])
    return types.SimpleNamespace(state0=state0, state=state, losses=losses, pmodel=pmodel, run=run, draws=draws,
                                 jmodel=jmodel, port=port, base_key=base_key)


def test_two_nr_demo_steps_match_jax(trained):
    run, state = trained.run, trained.state
    assert run["losses"].shape == (2,)
    for got, want in zip(run["losses"], trained.losses):
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    assert run["loss_first"] == pytest.approx(trained.losses[0], rel=1e-5)
    assert run["loss_final"] == pytest.approx(trained.losses[1], rel=1e-5)
    pstate = run["state"]
    assert pstate.step == int(state.step) == 2
    assert pstate.ema.num_updates == int(state.ema.num_updates) == 2
    want = train_state_from_jax(state, type(trained.pmodel)(trained.pmodel.run_config, device="cpu"))
    base = state_dict_from_jax(trained.state0.params)
    num = den = 0.0
    for name, got, exp in zip(pstate.names, pstate.ema.params, want.ema.params):
        if name.endswith("NIN_1.b"):
            continue
        num += ((got - base[name]) - (exp - base[name])).double().square().sum().item()
        den += (exp - base[name]).double().square().sum().item()
    assert (num / den) ** 0.5 <= 1e-3


def test_the_draws_are_init_hack_4s(trained):
    """The draws the port's steps took are those of the JAX recipe's loss:
    time, noise and init hack 4's row selection, no source shuffle (the
    recipe's train_source_order is None)."""
    assert trained.pmodel.loss_cfg.init_hack == 4
    for d in trained.draws:
        assert set(d) == {"time", "z", "select"}
        assert d["select"].shape == (B,) and d["z"].shape == (B, 2, N)


def test_a_row_pinned_to_t_max_matches_jax(trained):
    """Init hack 4's branch: a step from the JAX init at batch 16 whose draws
    (the JAX step's at step 1) pin a row to t = T, starting it from the
    noisy input's prior."""
    import torch

    mix, tgt = trained.port.make_batch(np.random.default_rng(SEED), 16, N)
    state = trained.state0.replace(step=jnp.asarray(1, trained.state0.step.dtype))
    _, metrics = jax.jit(trained.jmodel.make_train_step(trained.base_key))(state, jnp.asarray(mix), jnp.asarray(tgt))
    want = float(metrics["train/score_loss"])
    draws = jax_loss_draws(jax.random.fold_in(trained.base_key, 1), (16, 2, N), 4, "None")
    assert (draws["select"] < 1.0 / 30).sum() >= 1
    pmodel = trained.port.build_model("float32", False, "cpu", seed=SEED, nf=NF)
    pmodel.score_model.load_state_dict(state_dict_from_jax(trained.state0.params), strict=True)
    got = pmodel.make_train_step(1)(pmodel.init_state(), torch.from_numpy(mix), torch.from_numpy(tgt), draws=draws)
    got = float(got["train/score_loss"])
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
