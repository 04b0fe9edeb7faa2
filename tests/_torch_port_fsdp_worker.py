"""One rank of the port's FSDP tests (test_torch_port_fsdp.py).

    python tests/_torch_port_fsdp_worker.py PAYLOAD OUT_DIR RANK WORLD PORT

Joins a gloo group of WORLD ranks on the CPU and, for each strategy of the
payload ("ddp", "fsdp"), builds the port's model from the carried weights
and train state, shards it (``mesh.shard_fsdp`` + ``trainer.shard_state``)
or wraps it in DDP, and takes the payload's micro-steps on this rank's rows
of every batch and set of draws. It separates the payload's validation
mixture with the EMA weights before the first step and after it, as
``train.loop.validate`` does; under fsdp, rank 0 also separates it with a
one-process model that holds the gathered EMA weights. It writes the
metrics, the whole state (gathered), the separations and the bytes this
rank holds to OUT_DIR/rank<RANK>.pt. It imports neither JAX nor the JAX
package.
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from diffsep_tpu_torch.model import DiffSepModel  # noqa: E402
from diffsep_tpu_torch.parallel import mesh  # noqa: E402
from diffsep_tpu_torch.train import loop, trainer  # noqa: E402
from diffsep_tpu_torch.train.ema import swapped  # noqa: E402
from diffsep_tpu_torch.utils.distributed import initialize_distributed  # noqa: E402

SEPARATE = dict(predictor_name="ddim", corrector_name="none", N=2)


def rows(x, rank, world):
    per = x.shape[0] // world
    return x[rank * per:(rank + 1) * per]


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def separate(model, state, mix):
    with swapped(state.ema, state.params):
        return model.separate(mix, generator=torch.Generator().manual_seed(5), **SEPARATE)[0]


def run(payload, strategy, rank, world):
    model = DiffSepModel(payload["config"], device="cpu")
    model.score_model.load_state_dict(payload["model"], strict=True)
    state = model.init_state()
    state.load_state_dict(payload["state"])
    mesh.replicate_global(state)
    if strategy == "fsdp":
        layout = mesh.shard_fsdp(model.score_model, state.names, payload["min_size"])
        trainer.shard_state(state, layout)
        forward = model.score_model
    else:
        forward = mesh.wrap_ddp(model.score_model)
    step = model.make_train_step(seed=0, forward=forward)
    opt = state.optimizer
    out = {"bytes": {"params": nbytes(state.params), "optimizer": nbytes([*opt.mu, *opt.nu, *(opt.acc or [])]),
                     "ema": nbytes(state.ema.params)},
           "dims": state.fsdp.dims if state.fsdp is not None else None, "metrics": []}
    # a validation before the first step: the weight caches of the convs
    # fill under no_grad
    out["val_before"] = separate(model, state, payload["val_mix"])
    for i, (mix, tgt, draws) in enumerate(payload["steps"]):
        m = step(state, rows(mix, rank, world), rows(tgt, rank, world),
                 draws={k: rows(torch.as_tensor(v), rank, world) for k, v in draws.items()})
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 1:  # after the first applied update (accumulation 2)
            out["val_after"] = separate(model, state, payload["val_mix"])
            whole = state.state_dict()
            if rank == 0:
                ref = DiffSepModel(payload["config"], device="cpu")
                ref.score_model.load_state_dict({**payload["model"], **whole["ema"]["params"]}, strict=True)
                out["val_ref"] = ref.separate(payload["val_mix"], generator=torch.Generator().manual_seed(5),
                                              **SEPARATE)[0]
    out["state"] = state.state_dict()
    out["params"] = loop.whole_model_state(model, state)
    out["step"] = state.step
    return out


def main():
    payload, out_dir, rank, world, port = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    initialize_distributed(device_type="cpu", rank=rank, world_size=world, init_method=f"tcp://127.0.0.1:{port}")
    try:
        payload = torch.load(payload, weights_only=False)
        results = {s: run(payload, s, rank, world) for s in ("ddp", "fsdp")}
        torch.save(results, Path(out_dir) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
