"""``trainer.strategy: fsdp`` in the port (parallel/mesh.py ``shard_fsdp``,
``FsdpLayout``; train/trainer.py ``shard_state``; train/loop.py) on the CPU,
over two gloo ranks.

  * which parameters are split, and on which axis, equals the JAX package's
    ``fsdp_shardings`` on a mesh of the same size;
  * the 2-rank FSDP update against the 2-rank DDP update of the same rows,
    draws and state, over four micro-steps with accumulation 2 and the
    recipe's clip at 5, which binds (so the clip must take the whole
    gradient's norm, summed over the shards): the reported losses within
    1e-6 relative (the JAX package holds its ranks at ``rtol=1e-6``,
    tests/test_parallel.py), the gradient norms within 1e-6 relative, the
    parameters, Adam's moments and the EMA after the four micro-steps
    within 1e-5 of their norm;
  * each rank holds about half the sharded bytes of the parameters, the
    optimizer and the EMA;
  * a validation after an optimizer step (the weight caches of the convs
    filled by one before it) equals that of a one-process model holding the
    gathered EMA weights, within 1e-6 of scale;
  * ``cli.train.main`` with ``trainer.strategy=fsdp`` on two ranks under
    torchrun's environment: one run dir, a checkpoint laid out as a DDP
    run's (the same keys and shapes), read by a one-process resume and by
    ``cli.separate``.
Every spawned process has a timeout.
"""
import json
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_port_util import PORT_TINY_CONFIG, jax_score_model, random_params
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from diffsep_tpu.parallel.mesh import fsdp_shardings
from diffsep_tpu_torch.cli import separate as separate_cli
from diffsep_tpu_torch.cli import train as train_cli
from diffsep_tpu_torch.data.synthetic import write_wsj0_mix
from diffsep_tpu_torch.model import DiffSepModel
from diffsep_tpu_torch.models import state_dict_from_jax
from diffsep_tpu_torch.parallel import mesh
from test_torch_port_ddp import TESTS, TINY, _free_port, _run_ranks

LOSS_RTOL, NORM_RTOL, STATE_TOL, VAL_TOL = 1e-6, 1e-6, 1e-5, 1e-6
MIN_SIZE = 64  # small enough that the tiny model's convs and denses split


@pytest.mark.parametrize("n,min_size", [(2, 64), (4, 64), (2, 2 ** 16), (8, 8)])
def test_shard_dims_match_jax_fsdp_shardings(n, min_size):
    shapes = [(), (7,), (64,), (128,), (3, 3, 8, 16), (16, 8, 3, 3), (6, 10), (9, 9), (512, 256),
              (256, 256, 3, 3), (5, 3, 3, 30), (1024,)]
    jmesh = Mesh(np.asarray(jax.devices()[:n]), ("dp",))
    specs = fsdp_shardings([np.zeros(s, np.float32) for s in shapes], jmesh, min_size=min_size)
    want = [None if all(a is None for a in spec.spec) else [a for a in spec.spec].index("dp") for spec in specs]
    assert mesh.fsdp_shard_dims(shapes, n, min_size) == want


def _config():
    return {"model": dict(PORT_TINY_CONFIG, init_hack=5, init_hack_p=0.5, train_source_order="power",
                          grad_clipper={"_target_": "FixedClipper", "max_norm": 5.0}, optimizer={"lr": 1e-3}),
            "trainer": {"accumulate_grad_batches": 2}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same payload through two gloo ranks under DDP and under FSDP."""
    tmp = tmp_path_factory.mktemp("fsdp")
    rng = np.random.default_rng(11)
    model = DiffSepModel(_config(), device="cpu")
    model.score_model.load_state_dict(state_dict_from_jax(random_params(jax_score_model(), rng)), strict=True)
    steps = [(torch.from_numpy(0.3 * rng.standard_normal((4, 1, 800)).astype(np.float32)),
              torch.from_numpy(0.2 * rng.standard_normal((4, 2, 800)).astype(np.float32)), {}) for _ in range(4)]
    val_mix = torch.from_numpy(0.3 * rng.standard_normal((1, 1, 800)).astype(np.float32))
    payload = {"config": _config(), "model": model.score_model.state_dict(),
               "state": model.init_state().state_dict(), "steps": steps, "val_mix": val_mix,
               "min_size": MIN_SIZE}
    torch.save(payload, tmp / "payload.pt")
    port = _free_port()
    _run_ranks(lambda r: [str(TESTS / "_torch_port_fsdp_worker.py"), str(tmp / "payload.pt"), str(tmp), str(r), "2",
                          str(port)])
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)], payload


def _rel(got: dict, want: dict) -> float:
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in want)
    den = sum(float((want[k].double() ** 2).sum()) for k in want)
    return math.sqrt(num / den)


def test_fsdp_update_matches_ddp(runs):
    ranks, _ = runs
    for r in ranks:
        ddp, fsdp = r["ddp"], r["fsdp"]
        assert ddp["step"] == fsdp["step"] == 4
        for d, f in zip(ddp["metrics"], fsdp["metrics"]):
            assert abs(f["train/score_loss"] - d["train/score_loss"]) <= LOSS_RTOL * abs(d["train/score_loss"])
            assert abs(f["grad/norm"] - d["grad/norm"]) <= NORM_RTOL * d["grad/norm"]
            assert d["grad/norm"] > 5.0  # the clip binds
        assert fsdp["state"]["optimizer"]["count"] == ddp["state"]["optimizer"]["count"] == 2
        assert fsdp["state"]["ema"]["num_updates"] == 2
        assert _rel(fsdp["params"], ddp["params"]) <= STATE_TOL
        for part in ("mu", "nu"):
            assert _rel(fsdp["state"]["optimizer"][part], ddp["state"]["optimizer"][part]) <= STATE_TOL
        # the accumulator is zero after an applied update, and its shape whole
        acc_f, acc_d = fsdp["state"]["optimizer"]["acc"], ddp["state"]["optimizer"]["acc"]
        assert all(torch.equal(acc_f[k], acc_d[k]) for k in acc_d)
        assert _rel(fsdp["state"]["ema"]["params"], ddp["state"]["ema"]["params"]) <= STATE_TOL
    # the gathered states agree across the ranks
    a, b = ranks[0]["fsdp"], ranks[1]["fsdp"]
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    assert a["metrics"] == b["metrics"]


def test_fsdp_shards_the_state(runs):
    ranks, payload = runs
    dims = ranks[0]["fsdp"]["dims"]
    assert any(d is None for d in dims) and sum(d is not None for d in dims) >= 10
    whole = {k: v for k, v in payload["model"].items() if k in payload["state"]["ema"]["params"]}
    shapes = [tuple(v.shape) for v in whole.values()]
    assert dims == mesh.fsdp_shard_dims(shapes, 2, MIN_SIZE)
    split = sum(v.numel() * 4 for v, d in zip(whole.values(), dims) if d is not None)
    for r in ranks:
        d, f = r["ddp"]["bytes"], r["fsdp"]["bytes"]
        for part in ("params", "ema"):
            assert f[part] == d[part] - split // 2
        assert f["optimizer"] == d["optimizer"] - 3 * (split // 2)  # mu, nu and the accumulator


def test_validation_after_a_step_equals_the_gathered_model(runs):
    ranks, _ = runs
    got, want = ranks[0]["fsdp"]["val_after"], ranks[0]["fsdp"]["val_ref"]
    assert float((got - want).abs().max()) <= VAL_TOL * float(want.abs().max())
    # the step moved the EMA weights, so a stale weight cache would show
    assert float((got - ranks[0]["fsdp"]["val_before"]).abs().max()) > 1e-4 * float(want.abs().max())
    assert torch.equal(ranks[1]["fsdp"]["val_after"], got)
    ddp = ranks[0]["ddp"]["val_after"]
    assert float((got - ddp).abs().max()) <= 1e-5 * float(ddp.abs().max())


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_wsj0_mix(tmp_path_factory.mktemp("wsj0_mix"), {"train": 4, "val": 2}, seconds=0.5, seed=0)


def _overrides(data, exp_root, *extra):
    return ["experiment=icassp-separation", f"path.datasets.wsj0_mix={data}", f"path.exp_root={exp_root}",
            *TINY, *extra]


def test_cli_train_fsdp_two_ranks_then_resume_and_separate(data, tmp_path):
    exp = tmp_path / "exp"
    port = str(_free_port())
    extra = ["trainer.max_steps=4", "trainer.check_val_every_n_epoch=2", "trainer.strategy=fsdp",
             f"trainer.fsdp_min_size={MIN_SIZE}"]
    _run_ranks(lambda r: [str(TESTS / "_torch_port_fit_worker.py"), str(tmp_path / f"rank{r}.json"),
                          *_overrides(data, exp, *extra)],
               lambda r: dict(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                              MASTER_PORT=port))
    reports = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    assert [r["step"] for r in reports] == [4, 4] and all(r["world"] == 2 and not r["ddp"] for r in reports)
    # fit hands back the whole (gathered) state, equal on both ranks
    assert reports[0]["params"] == reports[1]["params"] and reports[0]["ema"] == reports[1]["ema"]
    assert [r["saves"] for r in reports] == [2, 0]
    (run,) = list((exp / "default").iterdir())
    index = json.loads((run / "checkpoints" / "index.json").read_text())
    assert sorted(index) == ["2", "4"] and all(math.isfinite(m["val/si_sdr"]) for m in index.values())

    # the checkpoint has a one-process run's layout
    fsdp_ckpt = torch.load(run / "checkpoints" / "4.pt", map_location="cpu", weights_only=True)
    one = train_cli.main(_overrides(data, tmp_path / "one", "trainer.max_steps=2"))
    (one_run,) = list((tmp_path / "one" / "default").iterdir())
    one_ckpt = torch.load(one_run / "checkpoints" / "2.pt", map_location="cpu", weights_only=True)
    assert {k: v.shape for k, v in fsdp_ckpt["model"].items()} == {k: v.shape for k, v in one_ckpt["model"].items()}
    for part in ("mu", "nu", "acc"):
        got, want = fsdp_ckpt["train_state"]["optimizer"][part], one_ckpt["train_state"]["optimizer"][part]
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert fsdp_ckpt["train_state"]["step"] == 4 and one.step == 2

    # a one-process resume goes on from step 4
    resumed = train_cli.main(_overrides(data, tmp_path / "exp2", "trainer.max_steps=6",
                                        f"trainer.resume_from_checkpoint={run}"))
    assert resumed.step == 6 and resumed.optimizer.count == 3 and resumed.ema.num_updates == 3

    # cli.separate reads the run dir in one process
    wavs = next(p for p in data.rglob("mix") if p.is_dir())
    out = tmp_path / "sep"
    separate_cli.main([str(wavs), str(out), "--model", str(run), "--device", "cpu", "-N", "2",
                       "--predictor", "ddim", "--corrector", "none"])
    assert sorted(out.rglob("*.wav"))
