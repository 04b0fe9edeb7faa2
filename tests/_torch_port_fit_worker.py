"""One rank of the port's two-process training test (test_torch_port_ddp.py).

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_port_fit_worker.py REPORT.json OVERRIDE...

Runs ``diffsep_tpu_torch.cli.train.main`` under torchrun's environment (so
it joins the gloo group as rank r) and writes what the test checks: the
rank's final step and a digest of its parameters and EMA, how many
checkpoints it saved, what its test evaluation returned. With
``PREEMPT_AT=k`` in the environment the rank sends itself SIGTERM after its
k-th micro-step. It imports neither JAX nor the JAX package.
"""
import hashlib
import json
import os
import signal
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from diffsep_tpu_torch.cli import evaluate as evaluate_cli  # noqa: E402
from diffsep_tpu_torch.cli import train as train_cli  # noqa: E402
from diffsep_tpu_torch.model import DiffSepModel  # noqa: E402
from diffsep_tpu_torch.parallel import mesh  # noqa: E402
from diffsep_tpu_torch.train.checkpoints import CheckpointManager  # noqa: E402


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def main():
    report_path, overrides = sys.argv[1], sys.argv[2:]
    torch.set_num_threads(1)
    report = {"saves": 0, "test": "not run", "digests": []}
    save, evaluate, make_step = CheckpointManager.save, evaluate_cli.evaluate_datamodule, DiffSepModel.make_train_step
    preempt_at = int(os.environ.get("PREEMPT_AT", 0))

    def counted_save(self, *args, **kwargs):
        report["saves"] += 1
        return save(self, *args, **kwargs)

    def recorded_evaluate(*args, **kwargs):
        out = evaluate(*args, **kwargs)
        report["test"] = None if out is None else [r["batch_idx"] for r in out[0]]
        return out

    def watched_step(self, seed, forward=None):
        step = make_step(self, seed, forward=forward)
        report["ddp"] = isinstance(forward, torch.nn.parallel.DistributedDataParallel)
        report["world"] = mesh.world_size()

        def run(state, *args, **kwargs):
            metrics = step(state, *args, **kwargs)
            # the parameters after every micro-step (bit-identical ranks)
            report["digests"].append(digest(state.params))
            if preempt_at and state.step == preempt_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return metrics

        return run

    CheckpointManager.save = counted_save
    evaluate_cli.evaluate_datamodule = recorded_evaluate
    DiffSepModel.make_train_step = watched_step
    state = train_cli.main(overrides)
    report.update(rank=int(os.environ["RANK"]), step=state.step,
                  preempted=state.preempted, params=digest(state.params), ema=digest(state.ema.params))
    Path(report_path).write_text(json.dumps(report))


if __name__ == "__main__":
    main()
