"""scripts/torch_port_train_demo_nr.py, the port's enhancement learning demo,
against the JAX package's scripts/train_demo_nr.py on the CPU (loaded by
path, its compile cache off).

* ``make_batch`` bit for bit, over three batches of seeds 0-2 and the
  held-out set;
* the demo's overrides are the JAX script's with the flags' dtype and remat,
  and the composed configs agree in every backbone, frontend, SDE, sampler,
  loss (init_hack, train_source_order), optimizer and EMA field: the recipe
  is PriorMixSDE, init_hack 4 and STFT 510 / 128 at 16 kHz;
* the CPU run's record has every key of scripts/train_demo_nr_result.json,
  and ``--save-ckpt`` writes the teacher file;
* ``--seeds`` runs one process per seed, hands each its teacher path, and
  its spread checks the bar on the records; the JAX record meets the bar.

Two demo steps against the JAX script's are in
test_torch_port_train_demo_nr_steps.py, the evaluation in
test_torch_port_train_demo_nr_eval.py (files of their own, so that test
workers run them at once).
"""
import ast
import functools
import json
import subprocess
import types

import numpy as np
import pytest

from _torch_port_util import SCRIPTS, load_script, without_targets
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from diffsep_tpu.config import compose as jax_compose
from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel

N = 16000


@pytest.fixture(scope="module")
def scripts():
    return types.SimpleNamespace(jax=load_script("train_demo_nr"), port=load_script("torch_port_train_demo_nr"))


def jax_overrides():
    """The override list of the JAX script's ``compose([...])`` call, read
    from its source."""
    tree = ast.parse((SCRIPTS / "train_demo_nr.py").read_text())
    call, = [n for n in ast.walk(tree) if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "compose"]
    return [ast.literal_eval(e) for e in call.args[0].elts]


@pytest.mark.parametrize("seed,b,calls", [(0, 16, 3), (1, 16, 3), (2, 16, 3), (123, 8, 1)],
                         ids=["seed0", "seed1", "seed2", "heldout"])
def test_make_batch_is_the_jax_scripts_bit_for_bit(scripts, seed, b, calls):
    rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(calls):
        (mj, tj), (mp, tp) = scripts.jax.make_batch(rj, b, N), scripts.port.make_batch(rp, b, N)
        assert mp.dtype == mj.dtype == tp.dtype == tj.dtype == np.float32
        assert mp.shape == (b, 1, N) and tp.shape == (b, 2, N)
        assert np.array_equal(mp, mj) and np.array_equal(tp, tj)
    assert scripts.port.FS == scripts.jax.FS == 16000 and scripts.port.SAMPLES == scripts.jax.N_SAMPLES


@pytest.mark.parametrize("dtype,remat", [("bfloat16", False), ("float32", True)])
def test_demo_config_is_the_jax_scripts(scripts, dtype, remat):
    from diffsep_tpu_torch.config.compose import compose
    from diffsep_tpu_torch.sde import PriorMixSDE

    overrides = scripts.port.nr_overrides(dtype, remat)
    want = [o.replace("dtype=bfloat16", f"dtype={dtype}") for o in jax_overrides()]
    remat_line = f"model.score_model.backbone_args.remat={str(remat).lower()}"
    assert [o for o in overrides if o != remat_line] == want and remat_line in overrides
    assert not any("train_source_order" in o for o in overrides)
    jcfg, pcfg = jax_compose(overrides), compose(overrides)
    jm, pm = jcfg.model, pcfg["model"]
    for key in ("backbone_args", "stft_args"):
        assert without_targets(pm["score_model"][key]) == without_targets(jm.score_model[key]), key
    for key in ("transform", "spec_abs_exponent", "spec_factor", "spec_trans_learnable", "num_sources"):
        assert pm["score_model"][key] == jm.score_model[key], key
    for key in ("sde", "sampler", "optimizer", "grad_clipper", "t_eps", "t_rev_init", "ema_decay",
                "train_source_order", "init_hack", "lr_warmup", "scheduler", "time_sampling_strategy", "fs"):
        assert without_targets(pm[key]) == without_targets(jm[key]), key
    assert pcfg["trainer"]["accumulate_grad_batches"] == jcfg.trainer.accumulate_grad_batches == 1
    # the recipe: PriorMixSDE, init hack 4, STFT 510 / 128 at 16 kHz
    assert pm["sde"]["_target_"].endswith("PriorMixSDE")
    assert {k: pm["sde"][k] for k in ("d_lambda", "sigma_min", "sigma_max", "N")} == {
        "d_lambda": 2.0, "sigma_min": 0.05, "sigma_max": 0.5, "N": 30}
    assert (pm["init_hack"], pm["t_eps"], pm["t_rev_init"], pm["fs"]) == (4, 0.03, 0.03, 16000)
    assert (pm["score_model"]["stft_args"]["n_fft"], pm["score_model"]["stft_args"]["hop_length"]) == (510, 128)
    jmodel = JaxDiffSepModel(jcfg)
    pmodel = scripts.port.build_model(dtype, remat, "cpu", seed=0)
    assert vars(pmodel.optim_cfg) == vars(jmodel.optim_cfg)
    assert vars(pmodel.loss_cfg) == vars(jmodel.loss_cfg)
    assert pmodel.loss_cfg.init_hack == 4 and pmodel.loss_cfg.train_source_order == "None"
    assert isinstance(pmodel.sde, PriorMixSDE) and pmodel.optim_cfg.lr == 1e-3
    bb = pmodel.score_model.backbone
    assert (bb.nf, bb.num_res_blocks, tuple(bb.ch_mult), tuple(bb.attn_resolutions)) == (32, 1, (1, 1, 2), (64,))
    assert bb.remat == remat


def test_cpu_run_writes_every_key_of_the_jax_record(scripts, tmp_path, capsys):
    from diffsep_tpu_torch.cli.loading import load_model

    out, ckpt = tmp_path / "record.json", tmp_path / "teacher.pt"
    assert scripts.port.main(["2", "--device", "cpu", "--tiny", "--dtype", "float32", "--seed", "1",
                              "--out", str(out), "--save-ckpt", str(ckpt)]) == 0
    record = json.loads(out.read_text())
    want = json.loads((SCRIPTS / "train_demo_nr_result.json").read_text())
    assert set(want) | {"seed", "card", "s_per_step", "launches_per_step", "peak_mem_gib"} <= set(record)
    assert record["steps"] == 2 and record["seed"] == 1 and record["dtype"] == "float32"
    assert record["card"] is None and record["device"] == "cpu" and record["launches_per_step"] == {}
    assert record["eval_nfe"] == 60 and record["peak_mem_gib"] is None
    assert all(np.isfinite(record[k]) for k in want if k.startswith(("si_sdr_", "pesq_wb_")))
    assert record["improvement_db"] == pytest.approx(record["si_sdr_enhanced_db"] - record["si_sdr_noisy_floor_db"],
                                                     abs=0.015)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-2]) == record
    assert json.loads(ckpt.with_suffix(".json").read_text()) == {
        "teacher_steps": 2, "teacher_train_time_s": record["train_time_s"], "seed": 1}
    assert load_model(ckpt, device="cpu").score_model.backbone.nf == 8


def test_seeds_run_one_process_each_and_check_the_bar(scripts, tmp_path, monkeypatch):
    """``--seeds`` with the JAX record as every seed's: each process gets its
    seed, record path and teacher path; the spread holds the si_sdr_* and
    pesq_wb_* metrics and the bar, which the JAX record meets."""
    jax_record = json.loads((SCRIPTS / "train_demo_nr_result.json").read_text())
    cmds = []

    class FakeProcess:
        def __init__(self, cmd):
            cmds.append(cmd)
            seed = int(cmd[cmd.index("--seed") + 1])
            record = dict(jax_record, seed=seed, card="x", s_per_step=0.1, peak_mem_gib=1.0,
                          launches_per_step={"conv3x3": 34.0})
            record["si_sdr_enhanced_db"] += 0.1 * seed
            (tmp_path / cmd[cmd.index("--out") + 1]).write_text(json.dumps(record))

        def wait(self):
            return 0

        def poll(self):
            return 0

    monkeypatch.setattr(subprocess, "Popen", FakeProcess)
    assert scripts.port.main(["2000", "--seeds", "0,1,2", "--out-dir", str(tmp_path),
                              "--save-ckpt", str(tmp_path / "teacher.pt")]) == 0
    assert [int(c[c.index("--seed") + 1]) for c in cmds] == [0, 1, 2]
    assert [c[c.index("--save-ckpt") + 1] for c in cmds] == [str(tmp_path / f"teacher_seed{s}.pt") for s in (0, 1, 2)]
    assert all(c[1].endswith("torch_port_train_demo_nr.py") and c[2] == "2000" for c in cmds)
    spread = json.loads((tmp_path / "torch_port_train_demo_nr_spread.json").read_text())
    assert spread["seeds"] == [0, 1, 2] and spread["train_steps"] == 2000
    assert spread["si_sdr_enhanced_db"]["values"] == [20.29, 20.39, 20.49]
    assert spread["pesq_wb_enhanced"]["min"] == 4.44 and "pesq_wb_noisy_floor" in spread
    assert spread["bar_met"] == {k: True for k in scripts.port.BAR}
    records = [dict(jax_record, seed=s) for s in range(3)]
    check_bar = functools.partial(scripts.port.demo.check_bar, bar=scripts.port.BAR)
    assert check_bar(records) == {k: True for k in scripts.port.BAR}
    for key, value in (("si_sdr_enhanced_db", 18.7), ("pesq_wb_enhanced", 4.19), ("si_sdr_noisy_floor_db", 8.96),
                       ("pesq_wb_noisy_floor", 1.884)):
        low = records[:2] + [dict(records[2], **{key: value})]
        assert check_bar(low) == {k: k != key for k in scripts.port.BAR}, key
    mean_low = [dict(r, si_sdr_enhanced_db=19.0) for r in records]
    assert not check_bar(mean_low)["si_sdr_enhanced_db"]


def test_plain_kernels_diagnostic_runs_the_plain_versions(scripts, monkeypatch):
    """``--plain-kernels`` trains and evaluates with every kernel wrapper
    replaced by its plain version, and restores the wrappers after."""
    from diffsep_tpu_torch.ops import conv3x3 as conv_mod
    from diffsep_tpu_torch.ops import fir_resample2x as fir_mod

    class Stop(Exception):
        """Raised by the training stand-in: the record is not needed here."""

    wrappers = (conv_mod.conv3x3, fir_mod.fir_down2x, fir_mod.fir_up2x)
    seen = []

    def train(*args, **kwargs):
        seen.append((conv_mod.conv3x3, fir_mod.fir_down2x, fir_mod.fir_up2x))
        raise Stop

    monkeypatch.setattr(scripts.port.demo, "train", train)
    with pytest.raises(Stop):
        scripts.port.main(["1", "--device", "cpu", "--tiny", "--plain-kernels"])
    assert seen == [(conv_mod.conv3x3_plain, fir_mod.fir_down2x_plain, fir_mod.fir_up2x_plain)]
    assert (conv_mod.conv3x3, fir_mod.fir_down2x, fir_mod.fir_up2x) == wrappers
    assert wrappers[0] is not conv_mod.conv3x3_plain


def test_own_init_is_drawn_as_jax_draws_it(scripts):
    """The port draws its own weights (the parity tests carry JAX's
    across), so the demo's seeds start from the distribution of the JAX
    script's PRNGKey(seed) only if every initializer matches: per parameter
    at nf 8, the same zero and constant tensors, and the
    spread of every tensor of 256 or more entries within 15% (over two
    seeds; 512 draws put the spread's own sampling error near 3%)."""
    import jax
    import jax.numpy as jnp
    import torch

    from diffsep_tpu_torch.models import state_dict_from_jax

    overrides = scripts.port.nr_overrides("float32", False, nf=8)
    jmodel = JaxDiffSepModel(jax_compose(overrides))
    mix, tgt = scripts.port.make_batch(np.random.default_rng(0), 1, 2000)
    jax_sds = [state_dict_from_jax(jmodel.init_params(jax.random.PRNGKey(s), jnp.asarray(mix), jnp.asarray(tgt)))
               for s in range(2)]
    port_sds = [scripts.port.build_model("float32", False, "cpu", seed=s, nf=8).score_model.state_dict()
                for s in range(2)]
    assert jax_sds[0].keys() == port_sds[0].keys()
    spread = 0
    for k in jax_sds[0]:
        j = torch.stack([sd[k] for sd in jax_sds]).double()
        p = torch.stack([sd[k] for sd in port_sds]).double()
        if torch.equal(j, j[:1].expand_as(j)):  # a constant: zeros, ones, the transform's scalars
            assert torch.equal(p, j), k
        elif j[0].numel() >= 256:
            assert 0.85 <= p.std().item() / j.std().item() <= 1.15, (k, p.std().item(), j.std().item())
            spread += 1
    assert spread >= 20
