"""scripts/torch_port_distill_demo.py on a present teacher file, on the CPU at
the tiny sizes (stages 2 and 1 of 2 steps each, the log grid): the run loads
the teacher and does not train it, scores the teacher first with the file's
weights and each student with its own stage's weights (those of the stage
cache), and a rerun on a stage cache trains its stages on the batches of an
uncut run. Then the demo's first distill step against the JAX package's, on
the linear grid and with on-policy rollouts, and the scores of
scripts/distill_port_parity.py against JAX's. The teacher file holds seeded
random weights: a 2-step teacher's score is so near 0 that its students
equal it.
"""
import json
import types
from unittest import mock

import numpy as np
import pytest
import torch

from _torch_port_util import load_script
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from diffsep_tpu_torch.config.compose import to_dict
from diffsep_tpu_torch.train.checkpoints import atomic_save, load_payload

TINY_ARGS = ["2", "--distill-steps", "2", "--stages", "2,1", "--schedule", "log", "--device", "cpu", "--tiny",
             "--dtype", "float32"]


def randomized(state_dict, seed):
    """Seeded weights of unit scale in every matrix and kernel."""
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=gen) / v[0].numel() ** 0.5 if v.ndim >= 2 else v
            for k, v in state_dict.items()}


@pytest.fixture(scope="module")
def loaded_run(tmp_path_factory):
    """The tiny run on a present teacher file of random weights (training
    it raises), with a stage cache, recording the weights of every score
    and the batch stream's position at every batch it serves."""
    port = load_script("torch_port_distill_demo")
    demo, scored, served = port.demo, [], []
    tmp = tmp_path_factory.mktemp("distill_loaded")
    model = demo.build_model("float32", False, "cpu", seed=0, nf=demo.TINY["nf"])
    teacher = randomized(model.score_model.state_dict(), 3)
    atomic_save({"state_dict": teacher, "config": to_dict(model.run_config)}, tmp / "teacher.pt")
    (tmp / "teacher.json").write_text(json.dumps({"teacher_steps": 2, "teacher_train_time_s": 1.5, "seed": 0}))
    score = port.score

    def recording(model, *args, **kw):
        scored.append((kw.get("predictor_name", "pc"), kw["N"],
                       {k: v.clone() for k, v in model.score_model.state_dict().items()}))
        return score(model, *args, **kw)

    call = port.BatchStream.__call__

    def counting(stream):
        served.append(stream.made)
        return call(stream)

    def run(name):
        out = tmp / f"{name}.json"
        served.clear()
        with mock.patch.object(port, "score", recording), mock.patch.object(port.BatchStream, "__call__", counting), \
                mock.patch.object(port, "train_teacher", side_effect=AssertionError("retrained")):
            assert port.main(TINY_ARGS + ["--teacher-ckpt", str(tmp / "teacher.pt"), "--stage-cache-dir",
                                          str(tmp / "stages"), "--out", str(out)]) == 0
        return json.loads(out.read_text()), list(served)

    record, first_served = run("loaded")
    stages = {2: load_payload(tmp / "stages" / "stage0_N2.pt"), 1: load_payload(tmp / "stages" / "stage1_N1.pt")}
    (tmp / "stages" / "stage1_N1.pt").unlink()
    rerun, rerun_served = run("rerun")
    return types.SimpleNamespace(tmp=tmp, record=record, scored=scored[:5], teacher=teacher, stages=stages,
                                 served=first_served, rerun=rerun, rerun_served=rerun_served,
                                 rerun_stage1=load_payload(tmp / "stages" / "stage1_N1.pt"))


def _same(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_present_teacher_is_loaded_not_trained(loaded_run):
    record = loaded_run.record
    assert record["teacher_train_time_s"] == 1.5 and record["teacher_steps"] == 2
    assert record["distill_steps_trained"] == 4 and record["stages"] == [2, 1]


def test_each_score_takes_its_own_weights(loaded_run):
    """The teacher is scored first, with the teacher file's weights; each
    student with its stage's (the stage cache), not the last stage's."""
    assert [(p, n) for p, n, _ in loaded_run.scored] == [("pc", 30), ("ddim", 1), ("ddim", 2), ("ddim", 2),
                                                         ("ddim", 1)]
    assert all(_same(sd, loaded_run.teacher) for _, _, sd in loaded_run.scored[:3])
    stages = loaded_run.stages
    assert _same(loaded_run.scored[3][2], stages[2]) and _same(loaded_run.scored[4][2], stages[1])
    assert not _same(stages[2], stages[1]) and not _same(stages[2], loaded_run.teacher)


def test_resumed_run_takes_the_uncut_runs_batches(loaded_run):
    """Stage 0 loaded from the cache, stage 1 trains on batches 2 and 3 of
    the stream, as in the uncut run, and to the same weights."""
    assert loaded_run.served == [0, 1, 2, 3]
    assert loaded_run.rerun_served == [2, 3] and loaded_run.rerun["distill_steps_trained"] == 2
    assert _same(loaded_run.rerun_stage1, loaded_run.stages[1])
    assert loaded_run.rerun["si_sdr_student_ddim_n1_db"] == loaded_run.record["si_sdr_student_ddim_n1_db"]


@pytest.mark.parametrize("schedule,n_student,on_policy_frac", [(None, 8, 0.0), ("log", 2, 0.5)],
                         ids=["linear_n8", "log_n2_on_policy"])
def test_first_distill_step_matches_jax(schedule, n_student, on_policy_frac):
    """The demo's first distill step (stage 0 of ``n_student`` steps, MixSDE,
    ``train_source_order=power``) on the first batch of its stream, against
    the JAX package's step with the draws of its key
    (``fold_in(fold_in(PRNGKey(42), 0), 0)``; the on-policy case draws the
    rollout's prior and rows too): the loss within 1e-4 relative. Student
    and teacher hold two seeded random weight sets of unit scale, carried
    across."""
    import jax
    import jax.numpy as jnp

    from _torch_port_util import jax_distill_draws, random_params
    from diffsep_tpu.config import compose as jax_compose
    from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel
    from diffsep_tpu.train import distill as jax_distill
    from diffsep_tpu_torch.models import state_dict_from_jax
    from diffsep_tpu_torch.train import distill

    port = load_script("torch_port_distill_demo")
    demo, n = port.demo, port.demo.TINY["samples"]
    jm = JaxDiffSepModel(jax_compose(demo.demo_overrides("float32", False, nf=demo.TINY["nf"])))
    rng = np.random.default_rng(13)
    student, teacher = random_params(jm.score_model, rng, n), random_params(jm.score_model, rng, n)
    mix, tgt = port.BatchStream(0, demo.TINY["batch"], n, torch.device("cpu"))()
    kw = dict(n_student=n_student, t_eps=jm.t_eps, teacher_substeps=2,
              source_order=jm.loss_cfg.train_source_order, schedule=schedule, on_policy_frac=on_policy_frac)
    stage_key = jax.random.fold_in(jax.random.PRNGKey(port.DISTILL_SEED), 0)
    step_fn = jax.jit(jax_distill.make_distill_step(jm.score_apply, jm.sde, jm.tx, jm.clipper, jm.optim_cfg,
                                                    stage_key, jax_distill.DistillConfig(**kw)))
    state = jax_distill.init_student_state(student, jm.tx, jm.clipper)
    _, metrics = step_fn(state, teacher, jnp.asarray(mix.numpy()), jnp.asarray(tgt.numpy()))
    want = float(metrics["distill/loss"])

    model = demo.build_model("float32", False, "cpu", seed=0, nf=demo.TINY["nf"])
    model.score_model.load_state_dict(state_dict_from_jax(teacher), strict=True)
    frozen = distill.frozen_copy(model.score_model)
    model.score_model.load_state_dict(state_dict_from_jax(student), strict=True)
    cfg = distill.DistillConfig(**kw)
    assert cfg.source_order == "power" and type(model.sde).__name__ == "MixSDE"
    draws = jax_distill_draws(jax.random.fold_in(stage_key, 0), jax_distill.DistillConfig(**kw), tuple(tgt.shape))
    assert ("onpol_prior" in draws) == (on_policy_frac > 0)
    step = distill.make_distill_step(model.score_model, model.sde, model.optim_cfg, 0, cfg)
    got = step(model.init_state(), frozen, mix, tgt, draws=draws)["distill/loss"].item()
    assert want > 0 and abs(got - want) <= 1e-4 * abs(want), (got, want)


def test_parity_script_scores_a_stage_as_jax(loaded_run):
    """scripts/distill_port_parity.py, the bisect of a missed bar, at the
    tiny sizes: a stage's weights separated by the JAX model and by the
    port's on the JAX sampler's draws read the same SI-SDR."""
    parity = load_script("distill_port_parity")
    tiny = parity.demo.TINY
    stage = loaded_run.tmp / "stages" / "stage0_N2.pt"
    got = parity.evaluate([stage], "ddim", 2, "log", nf=tiny["nf"], samples=tiny["samples"],
                          heldout=tiny["heldout"])[str(stage)]
    assert abs(got["jax"] - got["port_jax_draws"]) <= 0.01 and np.isfinite(got["port_own_generator"]), got
