"""Four accumulated micro-steps of the port's train step against the JAX
package's ``make_train_step``, in float32 on the CPU.

A JAX TrainState after three micro-steps (Adam moments, the MultiSteps
accumulator half full, one EMA update, AutoClip history) is carried across
with ``train_state_from_jax``; then both packages take four more
micro-steps with accumulate_grad_batches 2 on the same batches and the
same draws. Tolerances:
  * each micro-step's loss within 5e-5 relative (measured <= 1.7e-5: the
    loss is dominated by the smallest t, where the score is divided by a
    small sigma);
  * the parameters and the EMA as their change since the carried state,
    Adam's moments and the accumulated gradient, each within 1e-3 of its
    norm, over every tensor but the attention key biases (NIN_1.b): the
    softmax does not change when one constant is added to every key, so
    their gradient is 0 up to rounding, which Adam scales to steps of +-lr
    in either package's own direction;
  * the counters exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import PORT_TINY_CONFIG, TINY_BACKBONE, jax_loss_draws, jax_score_model, random_params
from diffsep_tpu.sde.mixsde import MixSDE as JaxMixSDE
from diffsep_tpu.train import trainer as jax_trainer
from diffsep_tpu_torch.model import DiffSepModel
from diffsep_tpu_torch.models import state_dict_from_jax, train_state_from_jax
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

VARIANTS = {
    # the recipe's settings, at a larger learning rate
    "recipe": dict(loss=dict(init_hack=5, init_hack_p=0.5, train_source_order="power"),
                   optim=dict(lr=1e-3, grad_clipper="fixed", clip_max_norm=5.0)),
    "adamw_autoclip_cosine": dict(
        loss=dict(init_hack=False, train_source_order="random"),
        optim=dict(lr=1e-3, weight_decay=0.01, lr_warmup=3, scheduler="cosine", scheduler_t_max=10,
                   grad_clipper="autoclip", autoclip_percentile=50.0)),
}


def _port_config(v):
    o = v["optim"]
    clip = ({"_target_": "FixedClipper", "max_norm": o["clip_max_norm"]} if o["grad_clipper"] == "fixed"
            else {"_target_": "AutoClipper", "p": o["autoclip_percentile"]})
    model = dict(PORT_TINY_CONFIG, **v["loss"], grad_clipper=clip,
                 optimizer={"lr": o["lr"], "weight_decay": o.get("weight_decay", 0.0)},
                 lr_warmup=o.get("lr_warmup"),
                 scheduler={"name": o["scheduler"], "T_max": o["scheduler_t_max"]} if "scheduler" in o else None)
    return {"model": model, "trainer": {"accumulate_grad_batches": 2}}


def _rel(got: dict, want: dict, base_got=None, base_want=None):
    """max over tensors of |got - want| / |want| (of the changes since the
    bases, where given), in L2 norm over all elements."""
    num = den = 0.0
    for k in want:
        if k.endswith("NIN_1.b"):
            continue
        g, w = got[k].double(), torch.as_tensor(np.asarray(want[k])).double()
        if base_got is not None:
            g, w = g - base_got[k].double(), w - torch.as_tensor(np.asarray(base_want[k])).double()
        num += ((g - w) ** 2).sum().item()
        den += (w ** 2).sum().item()
    return (num / den) ** 0.5


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_four_accumulated_micro_steps_match_jax(variant):
    v = VARIANTS[variant]
    rng = np.random.default_rng(3)
    jm = jax_score_model()
    params = random_params(jm, rng)
    net = jax.jit(jm.apply)
    loss_cfg = jax_trainer.LossConfig(**v["loss"])
    optim_cfg = jax_trainer.OptimConfig(accumulate_grad_batches=2, **v["optim"])
    tx, clipper = jax_trainer.make_optimizer(optim_cfg), jax_trainer.make_clipper(optim_cfg)
    base_key = jax.random.PRNGKey(4)
    step_fn = jax.jit(jax_trainer.make_train_step(
        lambda p, x, t, m: net({"params": p}, x, t, m), JaxMixSDE(), tx, clipper, loss_cfg, optim_cfg, base_key))
    batches = [(rng.standard_normal((3, 1, 800)).astype(np.float32) * 0.3,
                rng.standard_normal((3, 2, 800)).astype(np.float32) * 0.2) for _ in range(7)]
    state = jax_trainer.init_train_state(params, tx, clipper)
    for mix, tgt in batches[:3]:
        state, _ = step_fn(state, jnp.asarray(mix), jnp.asarray(tgt))

    model = DiffSepModel(_port_config(v), device="cpu")
    assert model.score_model.backbone.nf == TINY_BACKBONE["nf"]
    pstate = train_state_from_jax(state, model)
    assert pstate.step == 3 and pstate.optimizer.mini_step == 1 and pstate.optimizer.count == 1
    base_j = {"params": state_dict_from_jax(state.params), "ema": state_dict_from_jax(state.ema.params)}
    base_p = {"params": {k: p.detach().clone() for k, p in zip(pstate.names, pstate.params)},
              "ema": dict(zip(pstate.names, [e.clone() for e in pstate.ema.params]))}
    port_step = model.make_train_step(seed=0)
    for mix, tgt in batches[3:]:
        key = jax.random.fold_in(base_key, int(state.step))
        state, jm_metrics = step_fn(state, jnp.asarray(mix), jnp.asarray(tgt))
        draws = jax_loss_draws(key, tgt.shape, loss_cfg.init_hack, loss_cfg.train_source_order)
        pm_metrics = port_step(pstate, torch.from_numpy(mix), torch.from_numpy(tgt), draws=draws)
        want_loss = float(jm_metrics["train/score_loss"])
        assert abs(pm_metrics["train/score_loss"].item() - want_loss) <= 5e-5 * abs(want_loss)
        assert np.isclose(pm_metrics["lr"], float(jm_metrics["lr"]), rtol=1e-6)

    assert pstate.step == int(state.step) == 7
    inner = state.opt_state.inner_opt_state[0]
    assert pstate.optimizer.count == int(inner.count) == 3
    assert pstate.optimizer.mini_step == int(state.opt_state.mini_step) == 1
    assert pstate.ema.num_updates == int(state.ema.num_updates) == 3
    got_params = dict(zip(pstate.names, pstate.params))
    assert _rel(got_params, state_dict_from_jax(state.params), base_p["params"], base_j["params"]) <= 1e-3
    assert _rel(dict(zip(pstate.names, pstate.ema.params)), state_dict_from_jax(state.ema.params),
                base_p["ema"], base_j["ema"]) <= 1e-3
    assert _rel(dict(zip(pstate.names, pstate.optimizer.mu)), state_dict_from_jax(inner.mu)) <= 1e-3
    assert _rel(dict(zip(pstate.names, pstate.optimizer.nu)), state_dict_from_jax(inner.nu)) <= 1e-3
    assert _rel(dict(zip(pstate.names, pstate.optimizer.acc)), state_dict_from_jax(state.opt_state.acc_grads)) <= 1e-3
