"""``train_state_from_jax`` for the DiffuSE family (``model=diffuse``): a JAX
DiffuSE ``TrainState`` resumes in the port.

The converter is picked by the model's family (``diffuse_state_dict_from_jax``
for DiffuSE, ``state_dict_from_jax`` for NCSN++). A tiny JAX DiffuSE with
seeded unit-scale weights takes one micro-step (gradient accumulation 2, the
recipe's, so ``MultiSteps``'s accumulator is carried too); its state goes
across, and both packages take the next micro-step (the one that applies the
update) on the same batch and draws. Tolerances, those of
test_torch_port_train_step.py and test_torch_port_ddp.py: the loss within
1e-5 relative, the gradient norm within 1e-4 relative, the parameters' and
the EMA's change and Adam's moments within 1e-3 of their norm.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import jax_loss_draws, random_params
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from diffsep_tpu.config import compose as jax_compose
from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel
from diffsep_tpu.train import trainer as jax_trainer
from diffsep_tpu_torch.config import compose
from diffsep_tpu_torch.model import DiffSepModel
from diffsep_tpu_torch.models import diffuse_state_dict_from_jax, train_state_from_jax

OVERRIDES = ["model=diffuse", "model.score_model.backbone_args.residual_layers=4",
             "model.score_model.backbone_args.residual_channels=8",
             "model.score_model.backbone_args.dilation_cycle_length=3", "trainer.accumulate_grad_batches=2"]


def _rel(got, want, base_got=None, base_want=None):
    num = den = 0.0
    for k, w in want.items():
        g, w = got[k].double(), torch.as_tensor(np.asarray(w)).double()
        if base_got is not None:
            g, w = g - base_got[k].double(), w - torch.as_tensor(np.asarray(base_want[k])).double()
        num += float(((g - w) ** 2).sum())
        den += float((w ** 2).sum())
    return math.sqrt(num / den)


@pytest.fixture(scope="module")
def carried():
    jmodel = JaxDiffSepModel(jax_compose(OVERRIDES))
    params = random_params(jmodel.score_model, np.random.default_rng(31))
    rng = np.random.default_rng(32)
    batches = [((0.3 * rng.standard_normal((2, 1, 700))).astype(np.float32),
                (0.2 * rng.standard_normal((2, 2, 700))).astype(np.float32)) for _ in range(2)]
    base_key = jax.random.PRNGKey(33)
    step = jax.jit(jmodel.make_train_step(base_key))
    state = jax_trainer.init_train_state(params, jmodel.tx, jmodel.clipper)
    state, _ = step(state, *(jnp.asarray(v) for v in batches[0]))
    tmodel = DiffSepModel(compose(OVERRIDES), device="cpu")
    pstate = train_state_from_jax(state, tmodel)
    base = {"params": diffuse_state_dict_from_jax(state.params), "ema": diffuse_state_dict_from_jax(state.ema.params)}
    draws = jax_loss_draws(jax.random.fold_in(base_key, int(state.step)), batches[1][1].shape,
                           jmodel.loss_cfg.init_hack, jmodel.loss_cfg.train_source_order)
    state, metrics = step(state, *(jnp.asarray(v) for v in batches[1]))
    return jmodel, state, metrics, tmodel, pstate, batches[1], draws, base


def test_the_carried_state_is_diffuse_and_complete(carried):
    jmodel, _, _, tmodel, pstate, _, _, base = carried
    assert pstate.step == 1 and pstate.optimizer.mini_step == 1 and pstate.optimizer.count == 0
    assert all(k.startswith("backbone.") for k in pstate.names) and "backbone.input_projection.weight" in pstate.names
    got = dict(zip(pstate.names, (p.detach() for p in pstate.params)))
    assert all(torch.equal(got[k], base["params"][k]) for k in pstate.names)
    # the accumulator carries the first micro-step's clipped gradient
    assert any(float(a.abs().max()) > 0 for a in pstate.optimizer.acc)


def test_one_step_after_loading_equals_one_jax_step(carried):
    jmodel, state, metrics, tmodel, pstate, (mix, tgt), draws, base = carried
    base_got = {"params": {k: p.detach().clone() for k, p in zip(pstate.names, pstate.params)},
                "ema": {k: e.clone() for k, e in zip(pstate.names, pstate.ema.params)}}
    got = tmodel.make_train_step(seed=0)(pstate, torch.from_numpy(mix), torch.from_numpy(tgt), draws=draws)
    want_loss = float(metrics["train/score_loss"])
    assert abs(float(got["train/score_loss"]) - want_loss) <= 1e-5 * abs(want_loss)
    assert abs(float(got["grad/norm"]) - float(metrics["grad/norm"])) <= 1e-4 * float(metrics["grad/norm"])
    assert pstate.step == int(state.step) == 2 and pstate.optimizer.count == 1 and pstate.ema.num_updates == 1
    params = {k: p.detach() for k, p in zip(pstate.names, pstate.params)}
    assert _rel(params, diffuse_state_dict_from_jax(state.params), base_got["params"], base["params"]) <= 1e-3
    ema = dict(zip(pstate.names, pstate.ema.params))
    assert _rel(ema, diffuse_state_dict_from_jax(state.ema.params), base_got["ema"], base["ema"]) <= 1e-3
    inner = state.opt_state.inner_opt_state
    adam = next(s for s in jax.tree_util.tree_leaves(inner, is_leaf=lambda n: hasattr(n, "mu")) if hasattr(s, "mu"))
    assert _rel(dict(zip(pstate.names, pstate.optimizer.mu)), diffuse_state_dict_from_jax(adam.mu)) <= 1e-3
    assert _rel(dict(zip(pstate.names, pstate.optimizer.nu)), diffuse_state_dict_from_jax(adam.nu)) <= 1e-3
