"""One rank of the port's data-parallel update tests (test_torch_port_ddp.py).

    python tests/_torch_port_ddp_worker.py PAYLOAD OUT_DIR RANK WORLD PORT

Joins a gloo group of WORLD ranks on the CPU and, for each case of the
payload (written by the test with torch.save), builds the port's model from
the carried weights and train state, wraps the score model in DDP and takes
the case's steps on this rank's rows of every batch and of every set of
draws: the train step (``cli/train``'s path) or the distillation step.
Ranks other than 0 first spoil their state, which
``mesh.replicate_global`` must replace by rank 0's. It writes each case's final parameters, EMA, optimizer state and metrics to
OUT_DIR/rank<RANK>.pt. It imports neither JAX nor the JAX package.
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from diffsep_tpu_torch.model import DiffSepModel  # noqa: E402
from diffsep_tpu_torch.parallel import mesh  # noqa: E402
from diffsep_tpu_torch.sde import MixSDE  # noqa: E402
from diffsep_tpu_torch.train import distill  # noqa: E402
from diffsep_tpu_torch.utils.distributed import initialize_distributed  # noqa: E402


def rows(x, rank, world):
    per = x.shape[0] // world
    return x[rank * per:(rank + 1) * per]


def run_case(case, rank, world):
    model = DiffSepModel(case["config"], device="cpu")
    model.score_model.load_state_dict(case["model"], strict=True)
    state = model.init_state()
    state.load_state_dict(case["state"])
    if rank:
        # another rank's state diverged: replicate_global must restore rank 0's
        with torch.no_grad():
            for t in [*state.params, *state.ema.params, *state.optimizer.mu, *state.optimizer.nu]:
                t.add_(1.0)
        state.step, state.ema.num_updates, state.optimizer.count = 99, 99, 99
    mesh.replicate_global(state)
    ddp = mesh.wrap_ddp(model.score_model)
    assert isinstance(ddp, torch.nn.parallel.DistributedDataParallel)
    if case["kind"] == "train":
        step = model.make_train_step(seed=0, forward=ddp)

        def take(mix, tgt, draws):
            return step(state, mix, tgt, draws=draws)
    else:
        teacher = distill.frozen_copy(model.score_model)
        teacher.load_state_dict(case["teacher"], strict=True)
        step = distill.make_distill_step(model.score_model, MixSDE(), model.optim_cfg, 0,
                                         distill.DistillConfig(**case["distill_cfg"]), forward=ddp)

        def take(mix, tgt, draws):
            return step(state, teacher, mix, tgt, draws=draws)

    metrics = []
    for mix, tgt, draws in case["steps"]:
        m = take(rows(mix, rank, world), rows(tgt, rank, world),
                 {k: rows(torch.as_tensor(v), rank, world) for k, v in draws.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "state": state.state_dict(), "step": state.step}
    out["params"] = {k: p.detach().clone() for k, p in zip(state.names, state.params)}
    return out


def main():
    payload, out_dir, rank, world, port = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    initialize_distributed(device_type="cpu", rank=rank, world_size=world, init_method=f"tcp://127.0.0.1:{port}")
    try:
        cases = torch.load(payload, weights_only=False)
        results = {name: run_case(case, rank, world) for name, case in cases.items()}
        torch.save(results, Path(out_dir) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
