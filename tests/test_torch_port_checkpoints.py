"""The port's checkpoints: top-k by the monitored metric, the best-model
and latest symlinks, the atomic write, and an exact resume of the train
step from a checkpoint (bitwise equal parameters and state)."""
import numpy as np
import pytest
import torch

from _torch_port_util import PORT_TINY_CONFIG
from diffsep_tpu_torch.model import DiffSepModel
from diffsep_tpu_torch.train import checkpoints
from diffsep_tpu_torch.train.checkpoints import CheckpointManager, load_payload
from diffsep_tpu_torch.train.loop import restore
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("mode", ["max", "min"])
def test_top_k_and_symlinks(tmp_path, mode):
    ckpt = CheckpointManager(tmp_path / "ck", max_to_keep=2, monitor="val/si_sdr", mode=mode)
    scores = {10: 3.0, 20: 9.0, 30: 1.0, 40: 5.0, 50: float("nan")}
    for step, v in scores.items():
        ckpt.save(step, {"x": torch.tensor([float(step)])}, {"val/si_sdr": v})
    best = [20, 40] if mode == "max" else [30, 10]
    # the two best by the metric, and the newest (no finite metric: ranks last, kept to resume from)
    assert ckpt.all_steps() == sorted(best + [50])
    assert sorted(p.name for p in (tmp_path / "ck").glob("*.pt") if not p.is_symlink()) == \
        sorted(f"{s}.pt" for s in best + [50])
    assert (tmp_path / "ck" / "best-model.pt").resolve() == ckpt.path(best[0]).resolve()
    assert (tmp_path / "ck" / "latest.pt").resolve() == ckpt.path(50).resolve()
    assert ckpt.restore()["x"].item() == 50.0 and ckpt.restore(best[0])["metrics"] == {"val/si_sdr": scores[best[0]]}
    again = CheckpointManager(tmp_path / "ck", max_to_keep=2, mode=mode)  # reads index.json
    assert again.all_steps() == ckpt.all_steps() and again.best_step() == best[0]


def test_interrupted_write_leaves_the_old_checkpoint(tmp_path, monkeypatch):
    ckpt = CheckpointManager(tmp_path, monitor=None)
    ckpt.save(1, {"x": torch.ones(3)})

    def torn(obj, path):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoints.torch, "save", torn)
    with pytest.raises(OSError):
        ckpt.save(1, {"x": torch.zeros(3)})
    assert torch.equal(ckpt.restore(1)["x"], torch.ones(3))


def _model(accumulate=2):
    cfg = dict(PORT_TINY_CONFIG, optimizer={"lr": 1e-3}, grad_clipper={"_target_": "AutoClipper", "p": 50.0})
    return DiffSepModel({"model": cfg, "trainer": {"accumulate_grad_batches": accumulate}}, device="cpu", seed=1)


def test_resume_is_exact(tmp_path):
    rng = np.random.default_rng(0)
    batches = [(torch.from_numpy(rng.standard_normal((2, 1, 600)).astype(np.float32)),
                torch.from_numpy(rng.standard_normal((2, 2, 600)).astype(np.float32))) for _ in range(5)]
    a = _model()
    state_a, step_a = a.init_state(), a.make_train_step(seed=3)
    for mix, tgt in batches:
        step_a(state_a, mix, tgt)

    b = _model()
    state_b, step_b = b.init_state(), b.make_train_step(seed=3)
    for mix, tgt in batches[:3]:  # stops mid-accumulation
        step_b(state_b, mix, tgt)
    ckpt = CheckpointManager(tmp_path, monitor=None)
    ckpt.save(3, {"model": b.score_model.state_dict(), "train_state": state_b.state_dict()})

    c = _model()
    state_c = c.init_state()
    restore(c, state_c, load_payload(tmp_path / "latest.pt"))
    step_c = c.make_train_step(seed=3)
    for mix, tgt in batches[3:]:
        step_c(state_c, mix, tgt)
    assert state_c.step == state_a.step == 5 and state_c.optimizer.count == state_a.optimizer.count == 2
    assert state_c.clip_state.count == 5
    for x, y in zip(state_a.params + state_a.ema.params + state_a.optimizer.nu + state_a.optimizer.acc,
                    state_c.params + state_c.ema.params + state_c.optimizer.nu + state_c.optimizer.acc):
        assert torch.equal(x, y)
    assert torch.equal(state_a.clip_state.history, state_c.clip_state.history)
