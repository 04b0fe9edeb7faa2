"""scripts/torch_port_distill_demo_nr.py on a present teacher file, on the CPU
at the tiny sizes (stages 2 and 1 of 2 steps each): the run loads the
teacher and does not train it, scores the teacher first with the file's
weights, and each student with its own stage's weights (those of the stage
cache), not the last stage's. The teacher file holds seeded random weights:
a 2-step teacher's score is so near 0 that its students equal it.
"""
import json
import types
from unittest import mock

import pytest
import torch

from _torch_port_util import load_script
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from diffsep_tpu_torch.config.compose import to_dict
from diffsep_tpu_torch.train.checkpoints import atomic_save, load_payload

TINY_ARGS = ["2", "--distill-steps", "2", "--stages", "2,1", "--device", "cpu", "--tiny", "--dtype", "float32"]


def randomized(state_dict, seed):
    """Seeded weights of unit scale in every matrix and kernel: a 2-step
    teacher's score is so near 0 that its students equal it; these move."""
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=gen) / v[0].numel() ** 0.5 if v.ndim >= 2 else v
            for k, v in state_dict.items()}


@pytest.fixture(scope="module")
def loaded_run(tmp_path_factory):
    """The tiny run on a present teacher file of random weights (training
    it raises), with a stage cache, recording the weights of every score."""
    port = load_script("torch_port_distill_demo_nr")
    nr, scored = port.nr, []
    tmp = tmp_path_factory.mktemp("distill_nr_loaded")
    model = nr.build_model("float32", False, "cpu", seed=0, nf=nr.TINY["nf"])
    teacher = randomized(model.score_model.state_dict(), 3)
    atomic_save({"state_dict": teacher, "config": to_dict(model.run_config)}, tmp / "teacher.pt")
    (tmp / "teacher.json").write_text(json.dumps({"teacher_steps": 2, "teacher_train_time_s": 1.5, "seed": 0}))
    enhance_scores = nr.enhance_scores

    def recording(model, *args, **kw):
        scored.append((kw.get("predictor_name", "pc"), kw["N"],
                       {k: v.clone() for k, v in model.score_model.state_dict().items()}))
        return enhance_scores(model, *args, **kw)

    out = tmp / "loaded.json"
    with mock.patch.object(nr, "enhance_scores", recording), \
            mock.patch.object(port, "train_teacher", side_effect=AssertionError("retrained")):
        assert port.main(TINY_ARGS + ["--teacher-ckpt", str(tmp / "teacher.pt"), "--stage-cache-dir",
                                              str(tmp / "stages"), "--out", str(out)]) == 0
    return types.SimpleNamespace(tmp=tmp, record=json.loads(out.read_text()), scored=scored,
                                 teacher=teacher)


def test_present_teacher_is_loaded_not_trained(loaded_run):
    record = loaded_run.record
    assert record["teacher_train_time_s"] == 1.5 and record["teacher_steps"] == 2
    assert record["distill_steps_trained"] == 4 and record["stages"] == [2, 1]


def test_each_score_takes_its_own_weights(loaded_run):
    """The teacher is scored first, with the teacher file's weights; each
    student with its stage's (the stage cache), not the last stage's."""
    stages = {2: load_payload(loaded_run.tmp / "stages" / "stage0_N2.pt"),
              1: load_payload(loaded_run.tmp / "stages" / "stage1_N1.pt")}
    assert [(p, n) for p, n, _ in loaded_run.scored] == [("pc", 30), ("ddim", 1), ("ddim", 2), ("ddim", 2),
                                                         ("ddim", 1)]

    def same(a, b):
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

    assert all(same(sd, loaded_run.teacher) for _, _, sd in loaded_run.scored[:3])
    assert same(loaded_run.scored[3][2], stages[2]) and same(loaded_run.scored[4][2], stages[1])
    assert not same(stages[2], stages[1]) and not same(stages[2], loaded_run.teacher)


def test_first_distill_step_matches_jax():
    """The demo's first distillation step (stage 0, N=4 on the log grid, the
    recipe's source order None and PriorMixSDE at its published settings) on
    the first pool batch, against the JAX package's step with the draws of
    its key (``fold_in(fold_in(PRNGKey(42), 0), 0)``): the loss within 1e-4
    relative. Student and teacher hold two seeded random weight sets of unit
    scale, carried across, on which the score itself sits 0.7e-4 to 1.6e-4
    of scale from JAX's (at t = 0.03, 0.3 and 1); the loss read 5.9e-5 from
    it. A weighting that missed PriorMixSDE's envelope would be off by
    orders more (the unweighted loss of these inputs is 1.36 against 484)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from _torch_port_util import jax_distill_draws, random_params
    from diffsep_tpu.config import compose as jax_compose
    from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel
    from diffsep_tpu.train import distill as jax_distill
    from diffsep_tpu_torch.models import state_dict_from_jax
    from diffsep_tpu_torch.train import distill

    port = load_script("torch_port_distill_demo_nr")
    nr, n = port.nr, 2000
    jm = JaxDiffSepModel(jax_compose(nr.nr_overrides("float32", False, nf=nr.TINY["nf"])))
    rng = np.random.default_rng(11)
    student, teacher = random_params(jm.score_model, rng, n), random_params(jm.score_model, rng, n)
    mix, tgt = port.distill_pool(0, nr.TINY["batch"], n, torch.device("cpu"))[0]
    kw = dict(n_student=4, t_eps=jm.t_eps, teacher_substeps=2, source_order=jm.loss_cfg.train_source_order,
              schedule="log")
    stage_key = jax.random.fold_in(jax.random.PRNGKey(port.DISTILL_SEED), 0)
    step_fn = jax.jit(jax_distill.make_distill_step(jm.score_apply, jm.sde, jm.tx, jm.clipper, jm.optim_cfg,
                                                    stage_key, jax_distill.DistillConfig(**kw)))
    state = jax_distill.init_student_state(student, jm.tx, jm.clipper)
    _, metrics = step_fn(state, teacher, jnp.asarray(mix.numpy()), jnp.asarray(tgt.numpy()))
    want = float(metrics["distill/loss"])

    model = nr.build_model("float32", False, "cpu", seed=0, nf=nr.TINY["nf"])
    model.score_model.load_state_dict(state_dict_from_jax(teacher), strict=True)
    frozen = distill.frozen_copy(model.score_model)
    model.score_model.load_state_dict(state_dict_from_jax(student), strict=True)
    cfg = distill.DistillConfig(**kw)
    assert cfg.source_order == "None" and model.loss_cfg.train_source_order == "None"
    draws = jax_distill_draws(jax.random.fold_in(stage_key, 0), jax_distill.DistillConfig(**kw), tuple(tgt.shape))
    step = distill.make_distill_step(model.score_model, model.sde, model.optim_cfg, 0, cfg)
    got = step(model.init_state(), frozen, mix, tgt, draws=draws)
    got = got["distill/loss"].item()
    assert want > 0 and abs(got - want) <= 1e-4 * abs(want), (got, want)
