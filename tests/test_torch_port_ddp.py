"""Data parallelism in the port (parallel/mesh.py, utils/distributed.py, the
sharded loader, DDP in the train and distillation steps, cli/train.py's
ranks, preemption, the profiler and determinism) on the CPU, over gloo.

The JAX package is the oracle:
  * the loader's shards are the JAX DataLoader's, index for index, on the
    same seed: disjoint up to the wrap-around pad, covering the set, of
    equal length;
  * the 2-rank DDP update (each rank its half of every batch and of every
    set of draws) against the JAX ``make_train_step`` on the whole batch
    with the same draws, over two accumulated micro-steps from a carried
    state: the reported loss within 5e-5 relative, the gradient norm within
    1e-3 relative, the parameters' and the EMA's change, Adam's moments,
    each within 1e-3 of its norm (test_torch_port_train_step.py's
    tolerance, NIN_1.b left out as there), with the recipe's clip at 5,
    which binds on every micro-step there (a per-rank clip would give
    another update); the same for ``make_distill_step`` (loss 5e-5, the
    parameters' and the EMA's change 1e-3, the tolerances of
    test_torch_port_distill.py); the two ranks bit-identical after every
    step, also where rank 1 started from a spoiled state;
  * two processes each spawned here run the real ``cli.train.main`` under
    torchrun's environment (the counterpart of
    tests/test_parallel.py::test_two_process_fit_cpu): one run dir, rank 0
    the only writer, the ranks' parameters bit-identical after every
    micro-step, the test split sharded 2 + 1 and merged on rank 0; and a
    SIGTERM to one rank stops both at the next agreement step with one
    checkpoint there;
  * ``trainer.devices=2`` on the CPU spawns the two ranks itself;
  * the preemption path in one process (the counterpart of
    tests/test_e2e.py::test_preemption_checkpoint_and_resume), the
    profiler's trace and cuDNN's determinism flags.
Every spawned process has a timeout.
"""
import json
import math
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import (PORT_TINY_CONFIG, TINY_BACKBONE, TINY_SCORE, jax_distill_draws, jax_loss_draws,
                              jax_score_model, random_params)
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from diffsep_tpu.data.loader import DataLoader as JaxDataLoader
from diffsep_tpu.models import NCSNpp as JaxNCSNpp
from diffsep_tpu.models import ScoreModelNCSNpp as JaxScoreModel
from diffsep_tpu.sde.mixsde import MixSDE as JaxMixSDE
from diffsep_tpu.train import distill as jax_distill
from diffsep_tpu.train import trainer as jax_trainer
from diffsep_tpu_torch.cli import train as train_cli
from diffsep_tpu_torch.data.loader import DataLoader
from diffsep_tpu_torch.data.synthetic import write_wsj0_mix
from diffsep_tpu_torch.model import DiffSepModel
from diffsep_tpu_torch.models import state_dict_from_jax, train_state_from_jax
from diffsep_tpu_torch.parallel import mesh
from diffsep_tpu_torch.train import loop as loop_mod

TESTS = Path(__file__).resolve().parent
LOSS_TOL, NORM_TOL, STEP_TOL = 5e-5, 1e-3, 1e-3
TIMEOUT_S = 240

TINY = [
    "trainer.accelerator=cpu", "model.score_model.backbone_args.nf=8",
    "model.score_model.backbone_args.ch_mult=[1,2,2]", "model.score_model.backbone_args.num_res_blocks=1",
    "model.score_model.backbone_args.attn_resolutions=[]", "model.score_model.backbone_args.dtype=float32",
    "model.score_model.stft_args.n_fft=126", "model.score_model.stft_args.hop_length=32",
    "model.sampler.N=2", "model.sde.N=2", "model.valid_max_sep_batches=1",
    "datamodule.train.dl_opts.batch_size=2", "datamodule.val.dl_opts.batch_size=2",
]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(argv_of, env_of=lambda r: {}, world=2):
    """Run ``world`` processes (argv_of(rank), env_of(rank) added to the
    environment) to their end, each within TIMEOUT_S; all must exit 0."""
    procs = [subprocess.Popen([sys.executable, *argv_of(r)], env=dict(os.environ, OMP_NUM_THREADS="1", **env_of(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        deadline = time.monotonic() + TIMEOUT_S
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    return outs


# --------------------------------------------------------------------------
# the loader's shards, against the JAX DataLoader
# --------------------------------------------------------------------------
class _Indexed:
    """Item i: a (1, 4) mixture and a (2, 4) target filled with i."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((1, 4), i, np.float32), np.full((2, 4), i, np.float32)


def _indices(loader):
    return [int(v) for mix, _ in loader for v in mix[:, 0, 0]]


@pytest.mark.parametrize("n,shards,batch,shuffle", [(10, 2, 2, True), (10, 3, 2, True), (7, 2, 3, False),
                                                    (5, 4, 1, True)])
def test_loader_shards_match_jax(n, shards, batch, shuffle):
    got = []
    for s in range(shards):
        kw = dict(batch_size=batch, shuffle=shuffle, seed=3, prefetch=0, num_shards=shards, shard_index=s)
        port, ref = DataLoader(_Indexed(n), **kw), JaxDataLoader(_Indexed(n), **kw)
        idx = _indices(port)
        assert idx == _indices(ref) and len(port) == len(ref)
        got.append(idx)
    assert len({len(g) for g in got}) == 1  # equally many rows, so equally many batches
    assert set().union(*got) == set(range(n))
    pad = sum(len(g) for g in got) - n  # the wrap-around repeats the permutation's head
    assert 0 <= pad < shards


def test_loader_shard_index_checked_and_defaults_to_the_group():
    with pytest.raises(ValueError):
        DataLoader(_Indexed(4), num_shards=2)
    with pytest.raises(ValueError):
        DataLoader(_Indexed(4), num_shards=2, shard_index=2)
    default = DataLoader(_Indexed(4), batch_size=2, prefetch=0)
    assert (default.num_shards, default.shard_index) == (1, 0) and mesh.world_size() == 1
    assert mesh.wrap_ddp(torch.nn.Linear(2, 2)).__class__ is torch.nn.Linear  # no group: no wrap


# --------------------------------------------------------------------------
# the 2-rank DDP update, against the JAX step on the whole batch
# --------------------------------------------------------------------------
# the recipe's loss and clip at 5, at a larger learning rate: with these
# unit-scale weights the global gradient norm is in the hundreds, so the
# clip binds on every micro-step (asserted), where clipping each rank's own
# gradient would give another update
TRAIN_VARIANT = dict(loss=dict(init_hack=5, init_hack_p=0.5, train_source_order="power"),
                     optim=dict(lr=1e-3, grad_clipper="fixed", clip_max_norm=5.0))
DISTILL_BACKBONE = dict(TINY_BACKBONE, ch_mult=(1, 2))
DISTILL_CFG = dict(n_student=4, t_eps=0.03, teacher_substeps=2, source_order="power")


def _port_train_config(v):
    o = v["optim"]
    return {"model": dict(PORT_TINY_CONFIG, **v["loss"],
                          grad_clipper={"_target_": "FixedClipper", "max_norm": o["clip_max_norm"]},
                          optimizer={"lr": o["lr"]}),
            "trainer": {"accumulate_grad_batches": 2}}


def _torch(x):
    return torch.from_numpy(np.array(x))


def _train_case(v, rng):
    """The JAX run (2 micro-steps carried, 2 compared) and the payload of
    the port's ranks."""
    jm = jax_score_model()
    params = random_params(jm, rng)
    net = jax.jit(jm.apply)
    loss_cfg = jax_trainer.LossConfig(**v["loss"])
    optim_cfg = jax_trainer.OptimConfig(accumulate_grad_batches=2, **v["optim"])
    tx, clipper = jax_trainer.make_optimizer(optim_cfg), jax_trainer.make_clipper(optim_cfg)
    base_key = jax.random.PRNGKey(4)
    step_fn = jax.jit(jax_trainer.make_train_step(
        lambda p, x, t, m: net({"params": p}, x, t, m), JaxMixSDE(), tx, clipper, loss_cfg, optim_cfg, base_key))
    batches = [(rng.standard_normal((4, 1, 800)).astype(np.float32) * 0.3,
                rng.standard_normal((4, 2, 800)).astype(np.float32) * 0.2) for _ in range(4)]
    state = jax_trainer.init_train_state(params, tx, clipper)
    for mix, tgt in batches[:2]:
        state, _ = step_fn(state, jnp.asarray(mix), jnp.asarray(tgt))
    model = DiffSepModel(_port_train_config(v), device="cpu")
    pstate = train_state_from_jax(state, model)
    case = {"kind": "train", "config": _port_train_config(v), "model": model.score_model.state_dict(),
            "state": pstate.state_dict(), "steps": []}
    base = {"params": state_dict_from_jax(state.params), "ema": state_dict_from_jax(state.ema.params)}
    metrics = []
    for mix, tgt in batches[2:]:
        draws = jax_loss_draws(jax.random.fold_in(base_key, int(state.step)), tgt.shape, loss_cfg.init_hack,
                               loss_cfg.train_source_order)
        state, m = step_fn(state, jnp.asarray(mix), jnp.asarray(tgt))
        metrics.append({k: float(m[k]) for k in ("train/score_loss", "grad/norm")})
        case["steps"].append((_torch(mix), _torch(tgt), draws))
    inner = state.opt_state.inner_opt_state[0]
    want = {"params": state_dict_from_jax(state.params), "ema": state_dict_from_jax(state.ema.params),
            "mu": state_dict_from_jax(inner.mu), "nu": state_dict_from_jax(inner.nu), "metrics": metrics,
            "step": int(state.step), "count": int(inner.count), "base": base}
    return case, want


def _distill_case(rng):
    jm = JaxScoreModel(backbone=JaxNCSNpp(num_channels_in=6, num_channels_out=4, **DISTILL_BACKBONE),
                       num_sources=2, **TINY_SCORE)
    net = jax.jit(jm.apply)
    student, teacher = random_params(jm, rng), random_params(jm, rng)
    batches = [((0.3 * rng.standard_normal((4, 1, 1000))).astype(np.float32),
                (0.2 * rng.standard_normal((4, 2, 1000))).astype(np.float32)) for _ in range(2)]
    jopt = jax_trainer.OptimConfig(lr=1e-3, grad_clipper="fixed", clip_max_norm=5.0, ema_decay=0.999)
    tx, clipper = jax_trainer.make_optimizer(jopt), jax_trainer.make_clipper(jopt)
    base_key = jax.random.PRNGKey(6)
    jcfg = jax_distill.DistillConfig(**DISTILL_CFG)
    step_fn = jax.jit(jax_distill.make_distill_step(lambda p, x, t, m: net({"params": p}, x, t, m), JaxMixSDE(),
                                                    tx, clipper, jopt, base_key, jcfg))
    state = jax_trainer.init_train_state(student, tx, clipper)
    state, _ = step_fn(state, teacher, *(jnp.asarray(v) for v in batches[0]))
    config = {"score_model": {"stft_args": {k: TINY_SCORE[k] for k in ("n_fft", "hop_length")},
                              "backbone_args": dict(DISTILL_BACKBONE, dtype="float32")},
              "optimizer": {"lr": 1e-3}}
    model = DiffSepModel(config, device="cpu")
    pstate = train_state_from_jax(state, model)
    draws = jax_distill_draws(jax.random.fold_in(base_key, int(state.step)), jcfg, batches[1][1].shape)
    base = {"params": state_dict_from_jax(state.params), "ema": state_dict_from_jax(state.ema.params)}
    state, m = step_fn(state, teacher, *(jnp.asarray(v) for v in batches[1]))
    case = {"kind": "distill", "config": config, "model": model.score_model.state_dict(),
            "state": pstate.state_dict(), "teacher": state_dict_from_jax(teacher), "distill_cfg": DISTILL_CFG,
            "steps": [(_torch(batches[1][0]), _torch(batches[1][1]), draws)]}
    want = {"params": state_dict_from_jax(state.params), "ema": state_dict_from_jax(state.ema.params),
            "metrics": [{"distill/loss": float(m["distill/loss"])}], "step": int(state.step), "base": base}
    return case, want


@pytest.fixture(scope="module")
def ddp_runs(tmp_path_factory):
    """Every case through the JAX package and through two gloo ranks of
    the port (one pair of processes for all)."""
    tmp = tmp_path_factory.mktemp("ddp")
    rng = np.random.default_rng(3)
    cases, wants = {}, {}
    cases["train"], wants["train"] = _train_case(TRAIN_VARIANT, rng)
    cases["distill"], wants["distill"] = _distill_case(rng)
    torch.save(cases, tmp / "payload.pt")
    port = _free_port()
    _run_ranks(lambda r: [str(TESTS / "_torch_port_ddp_worker.py"), str(tmp / "payload.pt"), str(tmp), str(r), "2",
                          str(port)])
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return ranks, wants


def _rel(got: dict, want: dict, base_got=None, base_want=None):
    """|got - want| / |want| over every tensor but NIN_1.b (of the changes
    since the bases, where given), in L2 norm."""
    num = den = 0.0
    for k in want:
        if k.endswith("NIN_1.b"):
            continue
        g, w = got[k].double(), torch.as_tensor(np.asarray(want[k])).double()
        if base_got is not None:
            g, w = g - base_got[k].double(), w - torch.as_tensor(np.asarray(base_want[k])).double()
        num += float(((g - w) ** 2).sum())
        den += float((w ** 2).sum())
    return math.sqrt(num / den)


def _bit_identical(ranks, name):
    a, b = (r[name] for r in ranks)
    assert a["step"] == b["step"] and a["metrics"] == b["metrics"]
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    for part in ("mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(a["state"]["optimizer"][part].values(),
                                                     b["state"]["optimizer"][part].values()))
    assert all(torch.equal(x, y) for x, y in zip(a["state"]["ema"]["params"].values(),
                                                 b["state"]["ema"]["params"].values()))


def test_two_rank_ddp_update_matches_jax_whole_batch(ddp_runs):
    ranks, wants = ddp_runs
    got, want = ranks[0]["train"], wants["train"]
    _bit_identical(ranks, "train")
    for g, w in zip(got["metrics"], want["metrics"]):
        assert abs(g["train/score_loss"] - w["train/score_loss"]) <= LOSS_TOL * abs(w["train/score_loss"])
        assert abs(g["grad/norm"] - w["grad/norm"]) <= NORM_TOL * w["grad/norm"]
        assert w["grad/norm"] > TRAIN_VARIANT["optim"]["clip_max_norm"]  # the clip binds
    assert got["step"] == want["step"] == 4 and got["state"]["optimizer"]["count"] == want["count"] == 2
    base = {k: torch.as_tensor(np.asarray(v)) for k, v in want["base"]["params"].items()}
    base_ema = {k: torch.as_tensor(np.asarray(v)) for k, v in want["base"]["ema"].items()}
    assert _rel(got["params"], want["params"], base, want["base"]["params"]) <= STEP_TOL
    assert _rel(got["state"]["ema"]["params"], want["ema"], base_ema, want["base"]["ema"]) <= STEP_TOL
    assert _rel(got["state"]["optimizer"]["mu"], want["mu"]) <= STEP_TOL
    assert _rel(got["state"]["optimizer"]["nu"], want["nu"]) <= STEP_TOL


def test_two_rank_ddp_distill_step_matches_jax_whole_batch(ddp_runs):
    ranks, wants = ddp_runs
    got, want = ranks[0]["distill"], wants["distill"]
    _bit_identical(ranks, "distill")
    w = want["metrics"][0]["distill/loss"]
    assert abs(got["metrics"][0]["distill/loss"] - w) <= LOSS_TOL * abs(w)
    assert got["step"] == want["step"] == 2
    base = {k: torch.as_tensor(np.asarray(v)) for k, v in want["base"]["params"].items()}
    base_ema = {k: torch.as_tensor(np.asarray(v)) for k, v in want["base"]["ema"].items()}
    assert _rel(got["params"], want["params"], base, want["base"]["params"]) <= STEP_TOL
    assert _rel(got["state"]["ema"]["params"], want["ema"], base_ema, want["base"]["ema"]) <= STEP_TOL


# --------------------------------------------------------------------------
# the real training entry point on two ranks
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_wsj0_mix(tmp_path_factory.mktemp("wsj0_mix"), {"train": 4, "val": 2, "test": 3}, seconds=0.5,
                          seed=0)


def _overrides(data, exp_root, *extra):
    return ["experiment=icassp-separation", f"path.datasets.wsj0_mix={data}", f"path.exp_root={exp_root}",
            *TINY, *extra]


@pytest.mark.parametrize("case", ["train-validate-test", "sigterm-one-rank"])
def test_two_process_fit_cpu(data, tmp_path, case):
    exp = tmp_path / "exp"
    if case == "train-validate-test":
        extra, preempt = ["trainer.max_steps=4", "trainer.check_val_every_n_epoch=2", "test=true"], {}
    else:
        # rank 1 alone gets SIGTERM after micro-step 2; the ranks agree at 3
        extra = ["trainer.max_steps=50", "trainer.check_val_every_n_epoch=1000", "trainer.preempt_sync_every=3",
                 "test=true"]
        preempt = {1: {"PREEMPT_AT": "2"}}
    port = str(_free_port())
    _run_ranks(lambda r: [str(TESTS / "_torch_port_fit_worker.py"), str(tmp_path / f"rank{r}.json"),
                          *_overrides(data, exp, *extra)],
               lambda r: dict(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                              MASTER_PORT=port, **preempt.get(r, {})))
    reports = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    (run,) = list((exp / "default").iterdir())  # one run dir, shared
    assert [r["rank"] for r in reports] == [0, 1] and all(r["world"] == 2 and r["ddp"] for r in reports)
    # bit-identical after every micro-step, and at the end
    assert reports[0]["digests"] == reports[1]["digests"] and len(reports[0]["digests"]) == reports[0]["step"]
    assert reports[0]["params"] == reports[1]["params"] and reports[0]["ema"] == reports[1]["ema"]
    index = json.loads((run / "checkpoints" / "index.json").read_text())
    logged = [json.loads(line)["step"] for line in (run / "train_log.jsonl").read_text().splitlines()
              if '"step"' in line]
    if case == "train-validate-test":
        assert [r["step"] for r in reports] == [4, 4] and not any(r["preempted"] for r in reports)
        assert sorted(index) == ["2", "4"] and all(math.isfinite(m["val/si_sdr"]) for m in index.values())
        assert [r["saves"] for r in reports] == [2, 0]  # rank 0 writes, once per checkpoint
        assert logged == [1, 2, 3, 4]  # one writer of the log
        # the test split: 2 + 1 utterances, merged on rank 0
        assert reports[0]["test"] == [0, 1, 2] and reports[1]["test"] is None
        parts = [json.loads((run / "test_results" / f"part{r}" / "test.json").read_text()) for r in range(2)]
        assert [len(p) for p in parts] == [2, 1]
        merged = json.loads((run / "test_results" / "test.json").read_text())
        assert [m["len_s"] for m in merged] == [p["len_s"] for part in parts for p in part]
    else:
        assert [r["step"] for r in reports] == [3, 3] and all(r["preempted"] for r in reports)
        assert index == {"3": {}} and [r["saves"] for r in reports] == [1, 0]
        assert not (run / "checkpoints" / "best-model.pt").exists()
        assert all(r["test"] == "not run" for r in reports)  # no test split after a preemption


def test_devices_2_on_the_cpu_spawns_two_ranks(data, tmp_path):
    exp = tmp_path / "exp"
    assert train_cli.main(_overrides(data, exp, "trainer.devices=2", "trainer.max_steps=2",
                                     "trainer.check_val_every_n_epoch=2")) is None
    (run,) = list((exp / "default").iterdir())  # one run dir, one writer of its log
    assert sorted(json.loads((run / "checkpoints" / "index.json").read_text())) == ["2"]
    logged = [json.loads(line)["step"] for line in (run / "train_log.jsonl").read_text().splitlines()
              if '"step"' in line]
    assert logged == [1, 2]


def test_device_slots():
    """One process per entry: the published trainer file asks for every
    GPU; on the CPU -1 is one process and N is N."""
    from diffsep_tpu_torch.config import compose

    cfg = compose(["experiment=icassp-separation"])
    assert cfg.trainer.devices == -1 and cfg.trainer.strategy == "ddp"
    assert train_cli.device_slots(cfg.trainer, "cpu") == [None]
    assert train_cli.device_slots({"devices": 3}, "cpu") == [None] * 3
    assert train_cli.device_slots({"devices": [0, 1]}, "gpu") == [0, 1]
    assert train_cli.device_slots({"devices": [0, 0]}, "gpu") == [0, 0]  # two ranks share one card
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="accelerator=cpu"):
            train_cli.device_slots(cfg.trainer, "gpu")


# --------------------------------------------------------------------------
# preemption, the profiler and determinism in one process
# --------------------------------------------------------------------------
def _tiny_run(data, exp_root, *extra):
    from diffsep_tpu_torch.config import compose
    from diffsep_tpu_torch.data.datamodule import WSJ0_mix_Module

    cfg = compose(_overrides(data, exp_root, *extra))
    return DiffSepModel(cfg, device="cpu"), WSJ0_mix_Module(cfg, pad_to_multiple=8000), cfg


def test_preemption_checkpoint_and_resume(data, tmp_path):
    model, dm, cfg = _tiny_run(data, tmp_path, "trainer.check_val_every_n_epoch=1000000")
    workdir = tmp_path / "preempt_run"
    prior = signal.getsignal(signal.SIGTERM)

    def killer():
        # once fit has installed its handler, let a few steps run, then
        # deliver the signal to this process
        for _ in range(2400):
            if signal.getsignal(signal.SIGTERM) is not prior:
                break
            time.sleep(0.05)
        time.sleep(0.5)
        os.kill(os.getpid(), signal.SIGTERM)

    t = threading.Thread(target=killer, daemon=True)
    t.start()
    budget = 2000  # a backstop: the signal stops the run long before
    state = loop_mod.fit(model, dm, workdir, cfg, max_epochs=budget, max_steps=budget)
    t.join(timeout=60)
    assert not t.is_alive()
    saved = state.step
    assert state.preempted and 0 < saved < budget
    index = json.loads((workdir / "checkpoints" / "index.json").read_text())
    assert index == {str(saved): {}}  # the preemption save alone, without metrics
    assert not (workdir / "checkpoints" / "best-model.pt").exists()
    assert signal.getsignal(signal.SIGTERM) is prior  # restored on the way out
    model2, dm2, _ = _tiny_run(data, tmp_path, "trainer.check_val_every_n_epoch=1000000")
    state2 = loop_mod.fit(model2, dm2, workdir, cfg, max_epochs=budget, max_steps=saved + 2, resume="latest")
    assert state2.step == saved + 2 and not state2.preempted


def test_profiler_trace_and_deterministic_cudnn(data, tmp_path, monkeypatch):
    model, dm, cfg = _tiny_run(data, tmp_path, "trainer.profiler=true", "trainer.deterministic=true",
                               "trainer.max_steps=2")
    seen = []
    make_step = DiffSepModel.make_train_step

    def spy(self, seed, forward=None):
        step = make_step(self, seed, forward=forward)

        def run(*args, **kwargs):
            seen.append((torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark))
            return step(*args, **kwargs)

        return run

    monkeypatch.setattr(DiffSepModel, "make_train_step", spy)
    before = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    state = loop_mod.fit(model, dm, tmp_path / "run", cfg)
    assert state.step == 2 and seen == [(True, False)] * 2
    assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) == before
    trace = json.loads((tmp_path / "run" / "profile" / "trace_rank0.json").read_text())
    assert trace["traceEvents"]
