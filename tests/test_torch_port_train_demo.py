"""scripts/torch_port_train_demo.py, the port's separation learning demo,
against the JAX package's scripts/train_demo.py and scripts/seed_spread.py
on the CPU (both loaded by path, the JAX script with its compile cache off).

* ``make_batch`` bit for bit, over three batches of seeds 0-2 and the
  held-out set;
* the demo's overrides are the JAX script's, and the composed configs agree
  in every backbone, frontend, SDE, sampler, loss, optimizer and EMA field;
  a composed config without init_hack_p takes the JAX package's 1 / N;
* the CPU run's record has every key of scripts/train_demo_result.json;
* the aggregation reproduces scripts/seed_spread.py's on the JAX package's
  own seed records, and its bar sits below that record.

Two demo steps against the JAX script's are in
test_torch_port_train_demo_steps.py, the evaluation in
test_torch_port_train_demo_eval.py (files of their own, so that test
workers run the three at once).
"""
import ast
import json
import types

import numpy as np
import pytest

from _torch_port_util import SCRIPTS, load_script, without_targets
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from diffsep_tpu.config import compose as jax_compose
from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel


@pytest.fixture(scope="module")
def scripts():
    return types.SimpleNamespace(jax=load_script("train_demo"), port=load_script("torch_port_train_demo"),
                                 spread=load_script("seed_spread"))


def jax_overrides(dtype, remat):
    """The override list of the JAX script's ``compose([...])`` call, read
    from its source and evaluated with ``args.dtype`` and ``args.remat``."""
    tree = ast.parse((SCRIPTS / "train_demo.py").read_text())
    call, = [n for n in ast.walk(tree)
             if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "compose"]
    args = types.SimpleNamespace(dtype=dtype, remat=remat)
    return [eval(compile(ast.Expression(e), "train_demo.py", "eval"), {"args": args}) for e in call.args[0].elts]


@pytest.mark.parametrize("seed,b,calls", [(0, 16, 3), (1, 16, 3), (2, 16, 3), (123, 8, 1)],
                         ids=["seed0", "seed1", "seed2", "heldout"])
def test_make_batch_is_the_jax_scripts_bit_for_bit(scripts, seed, b, calls):
    rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(calls):
        (mj, tj), (mp, tp) = scripts.jax.make_batch(rj, b, 8000), scripts.port.make_batch(rp, b, 8000)
        assert mp.dtype == mj.dtype == tp.dtype == tj.dtype == np.float32
        assert mp.shape == (b, 1, 8000) and tp.shape == (b, 2, 8000)
        assert np.array_equal(mp, mj) and np.array_equal(tp, tj)


@pytest.mark.parametrize("dtype,remat", [("bfloat16", False), ("float32", True)])
def test_demo_config_is_the_jax_scripts(scripts, dtype, remat):
    from diffsep_tpu_torch.config.compose import compose

    overrides = scripts.port.demo_overrides(dtype, remat)
    assert overrides == jax_overrides(dtype, remat)
    jcfg, pcfg = jax_compose(overrides), compose(overrides)
    jm, pm = jcfg.model, pcfg["model"]
    for key in ("backbone_args", "stft_args"):
        assert without_targets(pm["score_model"][key]) == without_targets(jm.score_model[key]), key
    for key in ("transform", "spec_abs_exponent", "spec_factor", "spec_trans_learnable", "num_sources"):
        assert pm["score_model"][key] == jm.score_model[key], key
    for key in ("sde", "sampler", "optimizer", "grad_clipper", "t_eps", "ema_decay", "train_source_order",
                "init_hack", "lr_warmup", "scheduler", "time_sampling_strategy"):
        assert without_targets(pm[key]) == without_targets(jm[key]), key
    assert pcfg["trainer"]["accumulate_grad_batches"] == jcfg.trainer.accumulate_grad_batches == 1
    jmodel = JaxDiffSepModel(jcfg)
    pmodel = scripts.port.build_model(dtype, remat, "cpu", seed=0)
    assert vars(pmodel.optim_cfg) == vars(jmodel.optim_cfg)
    assert vars(pmodel.loss_cfg) == vars(jmodel.loss_cfg)
    bb = pmodel.score_model.backbone
    assert (bb.nf, bb.num_res_blocks, tuple(bb.ch_mult), tuple(bb.attn_resolutions)) == (32, 1, (1, 1, 2), (64,))


@pytest.mark.parametrize("overrides", [["model.init_hack=5"], ["experiment=icassp-separation"],
                                       ["experiment=noise-reduction", "model.init_hack=6"]],
                         ids=["default", "icassp", "noise_reduction"])
def test_init_hack_p_defaults_as_in_jax(overrides):
    """A composed config that leaves init_hack_p out takes 1 / N, as the
    JAX package does; the ICASSP recipe sets 0.1."""
    from diffsep_tpu_torch.config.compose import compose
    from diffsep_tpu_torch.model import DiffSepModel

    overrides = overrides + ["model.score_model.backbone_args.nf=8"]
    want = JaxDiffSepModel(jax_compose(overrides)).loss_cfg
    got = DiffSepModel(compose(overrides), device="cpu").loss_cfg
    assert (got.init_hack, got.init_hack_p) == (want.init_hack, want.init_hack_p)


def test_cpu_run_writes_every_key_of_the_jax_record(scripts, tmp_path, capsys):
    out = tmp_path / "record.json"
    assert scripts.port.main(["2", "--device", "cpu", "--tiny", "--dtype", "float32", "--seed", "1",
                              "--out", str(out)]) == 0
    record = json.loads(out.read_text())
    want = json.loads((SCRIPTS / "train_demo_result.json").read_text())
    assert set(want) | {"seed", "card", "s_per_step", "launches_per_step"} <= set(record)
    assert record["steps"] == 2 and record["seed"] == 1 and record["dtype"] == "float32"
    assert record["card"] is None and record["device"] == "cpu" and record["launches_per_step"] == {}
    assert record["eval_nfe"] == 102 and abs(record["si_sdr_mixture_floor_db"]) <= 0.01
    assert all(np.isfinite(record[k]) for k in want if k.startswith("si_sdr_"))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == record


def test_aggregate_is_seed_spreads(scripts):
    """On the JAX package's own seed records: the port's spread equals
    seed_spread's aggregation and the committed spread file, key for key,
    and that record meets the bar."""
    records = [json.loads((SCRIPTS / f"train_demo_seed{s}.json").read_text()) for s in (0, 1, 2)]
    keep = lambda k: k.startswith("si_sdr_")  # noqa: E731
    want = scripts.spread.aggregate([scripts.spread.add_derived_deltas(r) for r in records], keep)
    got = scripts.port.aggregate([scripts.port.add_derived_deltas(r) for r in records], keep)
    assert got == want
    committed = json.loads((SCRIPTS / "train_demo_spread.json").read_text())
    assert {k: v for k, v in committed.items() if k in want} == want
    for r in records:
        r["card"], r["s_per_step"], r["launches_per_step"] = "x", 1.0, {}
    spread = scripts.port.spread_record(records, 10000)
    assert all(spread["bar_met"].values()) and spread["bar_met"].keys() == scripts.port.BAR.keys()
    low = [dict(r, si_sdr_separated_db=24.7) for r in records]
    assert not scripts.port.spread_record(low, 10000)["bar_met"]["si_sdr_separated_db"]
