"""One rank of the port's tensor-parallel test (test_torch_port_tp.py).

    python tests/_torch_port_tp_worker.py PAYLOAD OUT_DIR RANK WORLD PORT

Joins a gloo group of WORLD ranks on the CPU and, for each (dp, tp) layout
of the payload, builds the port's model from the carried weights, shards it
with ``make_tp_separate`` and separates the payload's mixtures with the
carried noise and with a seeded generator. It writes the estimates and the
shape of every parameter this rank holds to OUT_DIR/rank<RANK>.pt. It
imports neither JAX nor the JAX package.
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from diffsep_tpu_torch.model import DiffSepModel  # noqa: E402
from diffsep_tpu_torch.parallel.tensor_parallel import make_tp_separate  # noqa: E402
from diffsep_tpu_torch.utils.distributed import initialize_distributed  # noqa: E402


def run(payload, dp, tp):
    model = DiffSepModel(payload["config"], device="cpu")
    model.score_model.load_state_dict(payload["model"], strict=True)
    sep = make_tp_separate(model, dp=dp, tp=tp, **payload["sampler"])
    est, nfe = sep(None, payload["mix"], noise=payload["noise"])
    seeded, _ = sep(torch.Generator().manual_seed(7), payload["mix"])
    return {"est": est, "nfe": nfe, "seeded": seeded,
            "shapes": {k: tuple(p.shape) for k, p in model.score_model.named_parameters()},
            "mesh": (sep.mesh.dp_index, sep.mesh.tp_index)}


def main():
    payload, out_dir, rank, world, port = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    initialize_distributed(device_type="cpu", rank=rank, world_size=world, init_method=f"tcp://127.0.0.1:{port}")
    try:
        payload = torch.load(payload, weights_only=False)
        results = {layout: run(payload, *layout) for layout in payload["layouts"]}
        torch.save(results, Path(out_dir) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
