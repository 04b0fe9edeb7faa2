"""scripts/torch_port_distill_demo_nr.py, the port's enhancement distillation
demo, against the JAX package's scripts/distill_demo_nr.py on the CPU (loaded
by path, its compile cache off).

* the distillation pool is the JAX script's, bit for bit (its first batches
  from ``default_rng(777 + seed)``), and the arguments are the JAX script's;
* the tiny CPU run (a 2-step teacher, stages 2 and 1 of 2 steps each)
  trains its teacher, writes the teacher file and every key of
  scripts/distill_demo_nr_result.json;
* a teacher sidecar whose steps or seed differ exits with the JAX script's
  message.

The run on a present teacher file is in test_torch_port_distill_demo_nr_loaded.py
(a file of its own, so that test workers run the two at once).
"""
import json
import types
from unittest import mock

import numpy as np
import pytest
import torch

from _torch_port_util import SCRIPTS, load_script
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from diffsep_tpu_torch.train.checkpoints import load_payload

TINY_ARGS = ["2", "--distill-steps", "2", "--stages", "2,1", "--device", "cpu", "--tiny", "--dtype", "float32"]


@pytest.fixture(scope="module")
def scripts():
    return types.SimpleNamespace(jax=load_script("distill_demo_nr"), jax_nr=load_script("train_demo_nr"),
                                 port=load_script("torch_port_distill_demo_nr"))


def test_pool_is_the_jax_scripts_bit_for_bit(scripts):
    pool = scripts.port.distill_pool(0, 16, 16000, torch.device("cpu"))
    assert len(pool) == scripts.port.POOL_BATCHES == 96
    drng = np.random.default_rng(777)
    for mix, tgt in pool[:3]:
        mj, tj = scripts.jax_nr.make_batch(drng, 16, 16000)
        assert mix.dtype == tgt.dtype == torch.float32
        assert np.array_equal(mix.numpy(), mj) and np.array_equal(tgt.numpy(), tj)


def _arguments(path):
    """The ``add_argument`` calls of a script's ``main``: {flag: default}."""
    import ast

    found = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            default = [k.value for k in node.keywords if k.arg == "default"]
            found[node.args[0].value] = ast.literal_eval(default[0]) if default and not isinstance(
                default[0], ast.Call) else None
    return found


def test_arguments_are_the_jax_scripts(scripts):
    jax_args, port_args = _arguments(SCRIPTS / "distill_demo_nr.py"), _arguments(SCRIPTS / "torch_port_distill_demo_nr.py")
    assert set(jax_args) <= set(port_args)
    assert {k: port_args[k] for k in jax_args if k != "--out"} == {k: v for k, v in jax_args.items() if k != "--out"}
    assert (scripts.port.POOL_SEED, scripts.port.DISTILL_SEED, scripts.port.LOG_EVERY) == (777, 42, 250)


@pytest.fixture(scope="module")
def tiny_run(scripts, tmp_path_factory):
    """The tiny CPU run, which trains its teacher and writes the teacher
    file."""
    tmp = tmp_path_factory.mktemp("distill_nr")
    out = tmp / "record.json"
    assert scripts.port.main(TINY_ARGS + ["--teacher-ckpt", str(tmp / "teacher.pt"), "--out", str(out)]) == 0
    return types.SimpleNamespace(tmp=tmp, record=json.loads(out.read_text()))


def test_cpu_run_writes_every_key_of_the_jax_record(tiny_run):
    record = tiny_run.record
    want = json.loads((SCRIPTS / "distill_demo_nr_result.json").read_text())
    keys = {k for k in want if "_n4" not in k}  # the tiny run's stages are 2 and 1
    assert keys | {"card", "s_per_distill_step", "launches_per_distill_step", "bar_met"} <= set(record)
    assert record["stages"] == [2, 1] and record["schedule"] == "log" and record["teacher_steps"] == 2
    assert record["distill_steps_per_stage"] == 2 and record["distill_steps_trained"] == 4
    assert record["card"] is None and record["launches_per_distill_step"] == {}
    assert all(np.isfinite(record[k]) for k in keys if k.startswith(("si_sdr_", "pesq_wb_")))
    assert set(record["bar_met"]) == {"si_sdr_teacher_pc_n30_db", "si_sdr_student_ddim_n2_db",
                                      "si_sdr_student_ddim_n1_db", "pesq_wb_student_ddim_n2",
                                      "pesq_wb_student_ddim_n1", "student_n1_vs_teacher_ddim_n1"}
    assert json.loads((tiny_run.tmp / "teacher.json").read_text()) == {
        "teacher_steps": 2, "teacher_train_time_s": record["teacher_train_time_s"], "seed": 0}


@pytest.mark.parametrize("argv,message", [
    (["3"], "holds a 2-step seed=0 teacher but the arguments say 3/seed=0"),
    (["2", "--seed", "1"], "holds a 2-step seed=0 teacher but the arguments say 2/seed=1"),
], ids=["steps", "seed"])
def test_mismatched_sidecar_exits(scripts, tiny_run, argv, message):
    with pytest.raises(SystemExit, match=message):
        scripts.port.main(argv + TINY_ARGS[1:] + ["--teacher-ckpt", str(tiny_run.tmp / "teacher.pt")])


def test_bar_checks_the_jax_record(scripts):
    record = json.loads((SCRIPTS / "distill_demo_nr_result.json").read_text())
    assert scripts.port.check_bar(record) == {**{k: True for k in scripts.port.BAR},
                                              "student_n1_vs_teacher_ddim_n1": True}
    low = dict(record, si_sdr_student_ddim_n1_db=12.0)
    assert scripts.port.check_bar(low)["student_n1_vs_teacher_ddim_n1"] is False
    assert scripts.port.check_bar(dict(record, pesq_wb_student_ddim_n2=2.99))["pesq_wb_student_ddim_n2"] is False
