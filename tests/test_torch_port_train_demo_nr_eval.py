"""The evaluation of the port's enhancement demos
(scripts/torch_port_train_demo_nr.py: ``evaluate`` and ``enhance_scores``,
which scripts/torch_port_distill_demo_nr.py scores its teacher and students
with) against the JAX scripts' evaluation code (scripts/train_demo_nr.py:
113-129, scripts/distill_demo_nr.py:164-172), on the CPU in float32 at nf 8
with the recipe's other settings, on two held-out clips of 0.5 s at 16 kHz
(PESQ-wb needs a quarter second).

A JAX train state whose EMA weights differ from its trained ones (seeded
random trees of unit scale, so that every layer counts) is carried across
with ``train_state_from_jax``; each sampler of the port gets the draws the
JAX sampler makes from the scripts' PRNGKey(7). PC N=30 (the EMA weights,
through ``evaluate``) and ddim N=1 and 2 on the log grid (the weights the
model holds, as the distillation demo scores its teacher) agree within 0.05
dB SI-SDR and 0.01 PESQ-wb, and so do the noisy floors; the port samples
the EMA weights and holds the trained ones after. The JAX samplers run in
threads, so that their compiles overlap.
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
from diffsep_tpu.models.losses import PESQ as JaxPESQ
from diffsep_tpu.models.losses import SISDRLoss as JaxSISDRLoss
from diffsep_tpu.train import trainer as jax_trainer
from diffsep_tpu_torch.models import state_dict_from_jax, train_state_from_jax

NF, B, N = 8, 2, 8000
SI_TOL, PESQ_TOL = 0.05, 0.01


def test_evaluation_matches_the_jax_scripts(monkeypatch):
    port = load_script("torch_port_train_demo_nr")
    jmodel = JaxDiffSepModel(jax_compose(port.nr_overrides("float32", False, nf=NF)))
    rng = np.random.default_rng(5)
    state = jax_trainer.init_train_state(random_params(jmodel.score_model, rng, N), jmodel.tx, jmodel.clipper)
    state = state.replace(ema=state.ema._replace(params=random_params(jmodel.score_model, rng, N)))
    mix_te, tgt_te = port.make_batch(np.random.default_rng(port.HELDOUT_SEED), B, N)
    clean_te = tgt_te[:, :1]
    key = jax.random.PRNGKey(port.EVAL_SEED)

    # the JAX scripts' evaluation code on the EMA weights
    si_sdr = JaxSISDRLoss(zero_mean=True, clamp_db=30, reduction="mean", sign_flip=True)
    pesq_wb = JaxPESQ(mode="wb", fs=16000, max_items=8)

    def jax_scores(**kw):
        est, _ = jmodel.separate(state.ema.params, key, jnp.asarray(mix_te), **kw)
        est_clean = np.asarray(est)[:, :1]
        return float(si_sdr(jnp.asarray(est_clean), jnp.asarray(clean_te))), float(pesq_wb(est_clean, clean_te))

    runs = {"pc_n30": dict(N=30)}
    for n_steps in (1, 2):
        runs[f"ddim_n{n_steps}"] = dict(predictor_name="ddim", corrector_name="none", N=n_steps, schedule="log")
    with ThreadPoolExecutor(3) as pool:
        futures = {k: pool.submit(jax_scores, **kw) for k, kw in runs.items()}
        want = {k: f.result() for k, f in futures.items()}
    want["floor"] = (float(si_sdr(jnp.asarray(mix_te), jnp.asarray(clean_te))), float(pesq_wb(mix_te, clean_te)))

    pmodel = port.build_model("float32", False, "cpu", seed=0, nf=NF)
    pstate = train_state_from_jax(state, pmodel)
    raw = [p.detach().clone() for p in pstate.params]
    separate, seen = pmodel.separate, []

    def spy(*args, **kw):
        seen.append(all(torch.equal(p, e) for p, e in zip(pstate.params, pstate.ema.params)))
        return separate(*args, **kw)

    monkeypatch.setattr(pmodel, "separate", spy)
    got = {"floor": port.floors(mix_te, tgt_te)}
    si, pq, nfe = port.evaluate(pmodel, pstate, mix_te, tgt_te, noise=jax_pc_noise(key, tgt_te.shape, 30))
    got["pc_n30"] = (si, pq)
    assert nfe == 60 and seen == [True]
    assert all(torch.equal(p, r) for p, r in zip(pstate.params, raw))
    # the distillation demo's teacher: the EMA weights loaded into the model
    pmodel.score_model.load_state_dict(state_dict_from_jax(state.ema.params), strict=True)
    for n_steps in (1, 2):
        si, pq, nfe = port.enhance_scores(pmodel, mix_te, tgt_te, noise=jax_pc_noise(key, tgt_te.shape, n_steps),
                                          **runs[f"ddim_n{n_steps}"])
        got[f"ddim_n{n_steps}"] = (si, pq)
        assert nfe == n_steps
    assert all(seen)
    assert all(np.isfinite(v).all() for v in want.values())
    for k, (si_want, pq_want) in want.items():
        assert abs(got[k][0] - si_want) <= SI_TOL, (k, got[k], want[k])
        assert abs(got[k][1] - pq_want) <= PESQ_TOL, (k, got[k], want[k])
