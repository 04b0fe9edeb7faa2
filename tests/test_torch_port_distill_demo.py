"""scripts/torch_port_distill_demo.py, the port's separation distillation
demo, against the JAX package's scripts/distill_demo.py on the CPU (loaded by
path, its compile cache off).

* the distillation batches are the JAX script's, bit for bit, step after
  step (a fresh batch from ``default_rng(777 + seed)`` each, no pool), and
  the arguments are the JAX script's;
* the tiny CPU run (a 2-step teacher, stages 2 and 1 of 2 steps each on the
  log grid) trains its teacher, writes the teacher file and every key of
  scripts/distill_demo_result.json; ``--seeds`` writes each seed's record
  and the spread with the distill gains;
* a teacher sidecar whose steps or seed differ exits with the JAX script's
  message; the bars read the JAX records as met.

The run on a present teacher file and the first distill step against JAX
are in test_torch_port_distill_demo_loaded.py (a file of its own, so that
test workers run the two at once).
"""
import json
import os
import types
from unittest import mock

import numpy as np
import pytest
import torch

from _torch_port_util import SCRIPTS, load_script
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

TINY_ARGS = ["2", "--distill-steps", "2", "--stages", "2,1", "--schedule", "log", "--device", "cpu", "--tiny",
             "--dtype", "float32"]


@pytest.fixture(scope="module")
def scripts():
    return types.SimpleNamespace(jax_demo=load_script("train_demo"), port=load_script("torch_port_distill_demo"))


def test_batch_stream_is_the_jax_scripts_bit_for_bit(scripts):
    """A fresh batch at every step, as distill_demo.py's ``batch_fn`` draws
    them; ``skip_to`` lands where an uncut stream is."""
    port = scripts.port
    stream = port.BatchStream(0, 16, 8000, torch.device("cpu"))
    drng = np.random.default_rng(777)
    for _ in range(3):
        mix, tgt = stream()
        mj, tj = scripts.jax_demo.make_batch(drng, 16, 8000, 8000)
        assert mix.dtype == tgt.dtype == torch.float32
        assert np.array_equal(mix.numpy(), mj) and np.array_equal(tgt.numpy(), tj)
    assert stream.served == stream.made == 3
    stream.skip_to(5)
    for _ in range(2):
        scripts.jax_demo.make_batch(drng, 16, 8000, 8000)
    mix, _ = stream()
    assert np.array_equal(mix.numpy(), scripts.jax_demo.make_batch(drng, 16, 8000, 8000)[0])
    assert (stream.served, stream.made) == (4, 6)
    other = port.BatchStream(1, 16, 8000, torch.device("cpu"))()
    assert np.array_equal(other[0].numpy(), scripts.jax_demo.make_batch(np.random.default_rng(778), 16, 8000)[0])


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
    """Every flag of distill_demo.py with its default; the schedule None is
    spelt "none"."""
    jax_args = _arguments(SCRIPTS / "distill_demo.py")
    port_args = _arguments(SCRIPTS / "torch_port_distill_demo.py")
    assert set(jax_args) <= set(port_args)
    jax_args["--schedule"] = "none" if jax_args["--schedule"] is None else jax_args["--schedule"]
    assert {k: port_args[k] for k in jax_args if k != "--out"} == {k: v for k, v in jax_args.items() if k != "--out"}
    assert port_args["teacher_steps"] == 3000 and port_args["--stages"] == "8,4,2,1"
    assert (scripts.port.BATCH_SEED, scripts.port.DISTILL_SEED, scripts.port.LOG_EVERY) == (777, 42, 250)


@pytest.fixture(scope="module")
def tiny_run(scripts, tmp_path_factory):
    """The tiny CPU run, which trains its teacher and writes the teacher
    file."""
    tmp = tmp_path_factory.mktemp("distill")
    out = tmp / "record.json"
    assert scripts.port.main(TINY_ARGS + ["--teacher-ckpt", str(tmp / "teacher.pt"), "--out", str(out)]) == 0
    return types.SimpleNamespace(tmp=tmp, record=json.loads(out.read_text()))


def test_cpu_run_writes_every_key_of_the_jax_record(tiny_run):
    record = tiny_run.record
    want = json.loads((SCRIPTS / "distill_demo_result.json").read_text())
    keys = {k for k in want if "_n4" not in k and "_n8" not in k}  # the tiny run's stages are 2 and 1
    assert keys | {"seed", "card", "s_per_distill_step", "launches_per_distill_step", "bar_met"} <= set(record)
    assert record["stages"] == [2, 1] and record["schedule"] == "log" and record["teacher_steps"] == 2
    assert record["on_policy_frac"] == 0.0 and record["distill_steps_per_stage"] == 2
    assert record["distill_steps_trained"] == 4
    assert record["card"] is None and record["launches_per_distill_step"] == {}
    assert all(np.isfinite(record[k]) for k in record if k.startswith("si_sdr_"))
    for n in (2, 1):
        assert record[f"si_sdr_delta_distill_gain_n{n}_db"] == round(
            record[f"si_sdr_student_ddim_n{n}_db"] - record[f"si_sdr_teacher_ddim_n{n}_db"], 2)
    assert set(record["bar_met"]) == set(record["bar"]) == {
        "si_sdr_student_ddim_n2_db", "si_sdr_student_ddim_n1_db", "si_sdr_delta_distill_gain_n2_db",
        "si_sdr_delta_distill_gain_n1_db", "si_sdr_teacher_pc_n30_db"}
    assert all(set(v) == {"each"} for v in record["bar"].values())  # one seed: no bar on the mean
    assert json.loads((tiny_run.tmp / "teacher.json").read_text()) == {
        "teacher_steps": 2, "teacher_train_time_s": record["teacher_train_time_s"], "seed": 0}


@pytest.mark.parametrize("argv,message", [
    (["3"], "holds a 2-step teacher but the teacher_steps argument is 3; delete the cache"),
    (["2", "--seed", "1"], "holds a seed=0 teacher but --seed is 1; delete the cache or match the seed"),
], ids=["steps", "seed"])
def test_mismatched_sidecar_exits(scripts, tiny_run, argv, message):
    with pytest.raises(SystemExit, match=message):
        scripts.port.main(argv + TINY_ARGS[1:] + ["--teacher-ckpt", str(tiny_run.tmp / "teacher.pt")])


def test_seeds_write_each_record_and_the_spread(scripts, tmp_path):
    """``--seeds 0,1``: a process per seed, each with its own teacher file
    and stage cache, then the spread with the distill gains and the bar of
    the log kind (on each seed and on the mean)."""
    argv = TINY_ARGS + ["--seeds", "0,1", "--out-dir", str(tmp_path), "--teacher-ckpt", str(tmp_path / "t.pt"),
                        "--stage-cache-dir", str(tmp_path / "stages")]
    with mock.patch.dict(os.environ, {"OMP_NUM_THREADS": "1"}):
        assert scripts.port.main(argv) == 0
    records = [json.loads((tmp_path / f"torch_port_distill_demo_log_seed{s}.json").read_text()) for s in (0, 1)]
    assert [r["seed"] for r in records] == [0, 1]
    assert all((tmp_path / f"t_seed{s}.json").exists() and (tmp_path / "stages" / f"seed{s}" / "stage1_N1.pt").exists()
               for s in (0, 1))
    spread = json.loads((tmp_path / "torch_port_distill_demo_log_spread.json").read_text())
    assert spread["seeds"] == [0, 1] and spread["n_seeds"] == 2 and spread["schedule"] == "log"
    assert spread["distill_steps_per_stage"] == 2 and spread["teacher_steps"] == 2
    for n in (2, 1):
        gains = spread[f"si_sdr_delta_distill_gain_n{n}_db"]
        assert gains["values"] == [r[f"si_sdr_delta_distill_gain_n{n}_db"] for r in records]
        assert set(gains) == {"mean", "min", "max", "spread", "values"}
    assert spread["bar"]["si_sdr_student_ddim_n2_db"] == {"each": 19.4, "mean": 20.1}
    assert set(spread["bar_met"]) == set(spread["bar"])


def test_bar_checks_the_jax_records(scripts):
    """Each kind's bar reads the JAX package's records as met: the pinned
    linear-grid run, the on-policy run, the three log seeds (each and
    their mean); a student at or below its teacher's ddim misses."""
    port = scripts.port

    def read(name):
        return json.loads((SCRIPTS / f"distill_demo_{name}.json").read_text())

    pinned, onpolicy = read("result"), read("onpolicy_result")
    seeds = [read(f"log_seed{s}") for s in (0, 1, 2)]
    for records, kind in (([pinned], "none"), ([onpolicy], "onpolicy"), (seeds, "log")):
        assert port.bar_kind(records[0]) == kind
        bar, met = port.check_bar(records)
        assert set(bar) == set(port.BAR[kind]) and all(met.values()), (kind, met)
    assert port.spread_record([dict(r, card=None, s_per_distill_step=None, launches_per_distill_step={})
                               for r in seeds], 10000)["bar_met"] == {k: True for k in port.BAR["log"]}
    even = dict(onpolicy, si_sdr_student_ddim_n2_db=onpolicy["si_sdr_teacher_ddim_n2_db"])
    assert port.check_bar([even])[1] == {"si_sdr_delta_distill_gain_n2_db": False}
    low = dict(pinned, si_sdr_student_ddim_n8_db=pinned["si_sdr_teacher_ddim_n8_db"] - 1.01)
    assert port.check_bar([low])[1]["si_sdr_delta_distill_gain_n8_db"] is False
    weak = [dict(r, si_sdr_student_ddim_n1_db=13.0) for r in seeds]
    assert port.check_bar(weak)[1]["si_sdr_student_ddim_n1_db"] is True
    assert port.check_bar([dict(r, si_sdr_student_ddim_n1_db=12.9) for r in seeds])[1][
        "si_sdr_student_ddim_n1_db"] is False  # each at least 12.4, but the mean below 13.0
    assert port.check_bar([dict(seeds[0], si_sdr_student_ddim_n1_db=12.9)], each_only=True)[1][
        "si_sdr_student_ddim_n1_db"] is True
