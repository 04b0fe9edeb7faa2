"""Two steps of the port's learning demo (scripts/torch_port_train_demo.py:
``train``) against the JAX script's loop (scripts/train_demo.py), on the CPU
in float32 at reduced width: nf 8, batch 2 x 2000 samples, the demo's data
stream from seed 0. The JAX init (``init_state(PRNGKey(0), ...)``) is
carried across with ``state_dict_from_jax``; the port's steps take the
draws of the JAX step (``fold_in(PRNGKey(1), step)``). Tolerances: each
loss within 1e-5 relative; the EMA's change since the init within 1e-3 of
its norm, against the JAX state carried across with
``train_state_from_jax``, without the attention key biases (NIN_1.b, whose
gradient is rounding: see tests/test_torch_port_train_step.py). The
teacher file that ``--save-ckpt`` writes holds the EMA weights.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import jax_loss_draws, load_script
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from diffsep_tpu.config import compose as jax_compose
from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel
from diffsep_tpu_torch.cli.loading import load_model
from diffsep_tpu_torch.models import state_dict_from_jax, train_state_from_jax

SEED, NF, B, N = 0, 8, 2, 2000


@pytest.fixture(scope="module")
def trained():
    jax_demo, port = load_script("train_demo"), load_script("torch_port_train_demo")
    jmodel = JaxDiffSepModel(jax_compose(port.demo_overrides("float32", False, nf=NF)))
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
    run = port.train(pmodel, SEED, 2, np.random.default_rng(SEED), B, N, log=lambda _: None,
                     draws=lambda i: jax_loss_draws(jax.random.fold_in(base_key, i), (B, 2, N), False, "power"))
    return types.SimpleNamespace(port=port, state0=state0, state=state, losses=losses, pmodel=pmodel, run=run)


def test_two_demo_steps_match_jax(trained):
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


def test_teacher_file_holds_the_ema_weights(trained, tmp_path):
    pmodel, pstate = trained.pmodel, trained.run["state"]
    record = {"steps": 2, "train_time_s": 1.0, "seed": SEED}
    trained.port.save_teacher(tmp_path / "teacher.pt", pmodel, pstate, record)
    loaded = load_model(tmp_path / "teacher.pt", device="cpu")
    ema = dict(zip(pstate.names, pstate.ema.params))
    weights = dict(loaded.score_model.named_parameters())
    assert weights.keys() == ema.keys()
    assert all(torch.equal(weights[k], ema[k]) for k in ema)
    assert not all(torch.equal(p, ema[k]) for k, p in zip(pstate.names, pstate.params))
    assert loaded.score_model.backbone.nf == NF
    assert json.loads((tmp_path / "teacher.json").read_text()) == {
        "teacher_steps": 2, "teacher_train_time_s": 1.0, "seed": SEED}
