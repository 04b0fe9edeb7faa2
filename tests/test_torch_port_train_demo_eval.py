"""The evaluation of the port's learning demo (scripts/torch_port_train_demo.py:
``evaluate``) against the JAX script's evaluation code
(scripts/train_demo.py:411-440), on the CPU in float32 at nf 8 with the
demo's other settings, on one held-out mixture of 2000 samples.

A JAX train state whose EMA weights differ from its trained ones (seeded
random trees of unit scale, so that every layer counts) is carried across
with ``train_state_from_jax``; each sampler of the port gets the draws the
JAX sampler makes from the script's PRNGKey(7). The SI-SDR of each sampler
and of the floor agree within 0.05 dB, and the port samples the EMA weights
and holds the trained ones after. The JAX samplers run in threads, so that
their seven compiles overlap.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port_util import jax_pc_noise, load_script, random_params
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from diffsep_tpu.config import compose as jax_compose
from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel
from diffsep_tpu.models.losses import SISDRLoss as JaxSISDRLoss
from diffsep_tpu.train import trainer as jax_trainer
from diffsep_tpu_torch.models import train_state_from_jax

NF, N = 8, 2000


def test_evaluation_matches_the_jax_scripts(monkeypatch):
    port = load_script("torch_port_train_demo")
    overrides = port.demo_overrides("float32", False, nf=NF)
    jmodel = JaxDiffSepModel(jax_compose(overrides))
    rng = np.random.default_rng(5)
    state = jax_trainer.init_train_state(random_params(jmodel.score_model, rng, N), jmodel.tx, jmodel.clipper)
    state = state.replace(ema=state.ema._replace(params=random_params(jmodel.score_model, rng, N)))
    mix_te, tgt_te = port.make_batch(np.random.default_rng(port.HELDOUT_SEED), 1, N)
    key = jax.random.PRNGKey(port.EVAL_SEED)

    # the JAX script's evaluation code on its EMA weights
    metric = JaxSISDRLoss(zero_mean=True, clamp_db=30, reduction="mean", sign_flip=True)

    def jax_si_sdr(**kw):
        est, _ = jmodel.separate(state.ema.params, key, jnp.asarray(mix_te), **kw)
        return float(metric(jnp.asarray(np.asarray(est)), jnp.asarray(tgt_te)))

    runs = {"si_sdr_separated_db": dict(N=30),
            "si_sdr_ddim_n6_db": dict(predictor_name="ddim", corrector_name="none", N=6)}
    for pred in ("ddim", "dpmpp"):
        for n_steps in (4, 6, 8):
            runs[f"si_sdr_{pred}_n{n_steps}_db"] = dict(predictor_name=pred, corrector_name="none", N=n_steps)
    with ThreadPoolExecutor(4) as pool:
        futures = {k: pool.submit(jax_si_sdr, **kw) for k, kw in runs.items()}
        want = {k: f.result() for k, f in futures.items()}
    want["si_sdr_mixture_floor_db"] = float(
        metric(jnp.broadcast_to(jnp.asarray(mix_te), tgt_te.shape), jnp.asarray(tgt_te)))

    pmodel = port.build_model("float32", False, "cpu", seed=0, nf=NF)
    pstate = train_state_from_jax(state, pmodel)
    raw = [p.detach().clone() for p in pstate.params]
    separate, seen = pmodel.separate, []

    def spy(*args, **kw):
        seen.append(all(torch.equal(p, e) for p, e in zip(pstate.params, pstate.ema.params)))
        return separate(*args, **kw)

    monkeypatch.setattr(pmodel, "separate", spy)
    got, nfe = port.evaluate(pmodel, pstate, mix_te, tgt_te,
                             noise=lambda kw: jax_pc_noise(key, tgt_te.shape, kw["N"]))
    assert len(seen) == 8 and all(seen)
    assert all(torch.equal(p, r) for p, r in zip(pstate.params, raw))
    assert nfe == 60 + 6 + 2 * (4 + 6 + 8)
    assert all(np.isfinite(v) for v in want.values())
    for k, v in want.items():
        assert abs(got[k] - v) <= 0.05, (k, got[k], v)
    assert abs(got["improvement_db"] - (got["si_sdr_separated_db"] - got["si_sdr_mixture_floor_db"])) <= 0.015
