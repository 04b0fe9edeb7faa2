"""Training entry point.

    python -m diffsep_tpu_torch.cli.train experiment=icassp-separation \\
        path.datasets.wsj0_mix=/data/wsj0_mix [trainer.max_steps=N] [...]
    python -m diffsep_tpu_torch.cli.train experiment=noise-reduction \\
        path.datasets.valentini=/data/VCTK_DEMAND test=true [...]
    torchrun --nproc-per-node 8 -m diffsep_tpu_torch.cli.train experiment=icassp-separation [...]

Counterpart of ``diffsep_tpu/cli/train.py``: the composed config with
dotted overrides, the run dir ``<path.exp_root>/<name>/<timestamp>_<overrides>/``,
the seed, the datamodule by experiment name (``enhancement``: VCTK-DEMAND,
else WSJ0-mix), ``trainer.resume_from_checkpoint`` (or the top-level
``resume_from_checkpoint``), ``load_pretrained``, and ``test=true``, which
scores the test split with the EMA weights after training
(``cli/evaluate.py``: ``<run dir>/test_results/test.json``; with
``train=false``, freshly initialized weights). It trains on CUDA
(``trainer.accelerator: gpu``) unless ``trainer.accelerator=cpu`` asks for
the CPU.

Devices, as Lightning reads ``trainer.devices`` for the reference: -1
(``trainer=allgpus``, the ICASSP recipe's) is every visible GPU, N the first
N, a list those indices (an index given twice puts two ranks on one card).
On the CPU, -1 is one process and N is N processes. One device trains in
this process. Several train data-parallel, one process per device spawned
here, each joined to a process group (NCCL; gloo on the CPU or where ranks
share a card) and the score model in DDP (``parallel/mesh.py``): each rank
takes ``batch_size`` rows of its own shard, so the global batch is
devices x batch_size. ``trainer.strategy=fsdp`` shards the parameters,
gradients, optimizer state and EMA over those ranks instead of
replicating them (``train/loop.py``). Under torchrun the process joins
torchrun's group instead and trains as its rank. A worker that fails fails the run: the
others are stopped, and collectives time out.
"""
from __future__ import annotations

import datetime
import hashlib
import logging
import os
import signal
import socket
import sys
import time
from pathlib import Path
from typing import List, Optional

from ..config import ConfigNode, compose
from ..parallel import mesh

log = logging.getLogger(__name__)

DEVICES = {"gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}


def make_run_dir(cfg, overrides) -> Path:
    # rank 0's clock names the run dir of every rank: ranks started across a
    # second boundary would otherwise write into different dirs
    ts = mesh.broadcast_object(datetime.datetime.now()).strftime("%Y-%m-%d_%H-%M-%S")
    tag = "_".join(o.replace("/", ".") for o in overrides if "=" in o and not o.startswith("path."))
    tag = "".join(c for c in tag if c not in "[]*?,' \"")
    if len(tag) > 120:  # keep run-dir names filesystem-safe
        tag = tag[:100] + "-" + hashlib.sha1(tag.encode()).hexdigest()[:8]
    d = Path(cfg.path.exp_root) / str(cfg.name) / (f"{ts}_{tag}" if tag else ts)
    d.mkdir(parents=True, exist_ok=True)
    return d


def load_pretrained(path: Path):
    """(score_model config, parameters, EMA parameters) of a checkpoint of
    this package: a ``.pt`` file, or a run or checkpoints dir (its
    best-model, else its latest)."""
    from .loading import read_checkpoint

    if (path / "checkpoints").is_dir():
        path = path / "checkpoints"
    if path.is_dir():
        path = path / "best-model.pt" if (path / "best-model.pt").exists() else path / "latest.pt"
    config, params, ema = read_checkpoint(path)
    return config["model"]["score_model"], params, ema


def device_slots(trainer_cfg, accelerator: str) -> List[Optional[int]]:
    """One entry per training process: its CUDA index, or None on the CPU."""
    devices = trainer_cfg.get("devices", 1)
    if DEVICES[accelerator] == "cpu":
        if isinstance(devices, (list, tuple)):
            return [None] * len(devices)
        return [None] * (1 if devices in (-1, "auto") else int(devices))
    if isinstance(devices, (list, tuple)):
        return [int(d) for d in devices]
    import torch

    visible = torch.cuda.device_count()
    if devices in (-1, "auto"):
        if visible == 0:
            raise RuntimeError("trainer.devices=-1 trains on every GPU, and none is visible; "
                               "pass trainer.accelerator=cpu to train on the CPU")
        return list(range(visible))
    n = int(devices)
    if n > visible:
        raise RuntimeError(f"trainer.devices={n}: {visible} GPU(s) visible")
    return list(range(n))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(overrides, slots: List[Optional[int]], accelerator: str) -> None:
    """Train on one process per entry of ``slots``, spawned here; returns
    when all have finished, and raises as soon as one fails (the others
    are terminated). A SIGTERM to this process is passed on to every rank."""
    import multiprocessing

    from diffsep_tpu_torch.cli.train import _worker  # by its module path, also when run as __main__

    on_gpu = DEVICES[accelerator] == "cuda"
    backend = "nccl" if on_gpu and len(set(slots)) == len(slots) else "gloo"
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(list(overrides), r, len(slots), init_method, backend,
                                                accelerator, idx), name=f"train-rank{r}")
             for r, idx in enumerate(slots)]
    log.info("training on %d processes (%s, devices %s)", len(procs), backend, slots)
    for p in procs:
        p.start()

    def forward_sigterm(signum, frame):
        # preemption reaches the ranks, which agree, save and stop
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signal.SIGTERM)

    try:
        prev = signal.signal(signal.SIGTERM, forward_sigterm)
    except ValueError:  # not the main thread
        prev = None
    try:
        while True:
            codes = [p.exitcode for p in procs]
            failed = [(p.name, c) for p, c in zip(procs, codes) if c not in (None, 0)]
            if failed:
                raise RuntimeError(f"training worker(s) failed: {failed}")
            if all(c == 0 for c in codes):
                return
            time.sleep(0.2)
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=30)


def _worker(overrides, rank: int, world_size: int, init_method: str, backend: str, accelerator: str,
            index: Optional[int]) -> None:
    """One spawned rank: join the group, train, leave the group."""
    import torch.distributed as dist

    from ..utils.distributed import initialize_distributed

    logging.basicConfig(level=logging.INFO, format=f"[rank {rank}] %(levelname)s %(name)s: %(message)s")
    if index is None:
        # the ranks share the host's cores, as torchrun shares them
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    initialize_distributed(backend=backend, device_type=DEVICES[accelerator], rank=rank,
                           world_size=world_size, init_method=init_method, device_index=index)
    try:
        train(compose(overrides), overrides, "cpu" if index is None else f"cuda:{index}")
    finally:
        dist.destroy_process_group()


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg = compose(overrides)
    trainer_cfg = cfg.get("trainer") or {}
    accelerator = trainer_cfg.get("accelerator", "gpu")
    if accelerator not in DEVICES:
        raise ValueError(f"trainer.accelerator={accelerator!r}: expected one of {sorted(DEVICES)}")

    from ..utils.distributed import initialize_distributed, torchrun_env

    if torchrun_env():
        import torch
        import torch.distributed as dist

        initialize_distributed(device_type=DEVICES[accelerator])
        device = "cpu" if DEVICES[accelerator] == "cpu" else f"cuda:{torch.cuda.current_device()}"
        try:
            return train(cfg, overrides, device)
        finally:
            dist.destroy_process_group()
    slots = device_slots(trainer_cfg, accelerator)
    if len(slots) > 1:
        return spawn(overrides, slots, accelerator)
    return train(cfg, overrides, "cpu" if slots[0] is None else f"cuda:{slots[0]}")


def train(cfg, overrides, device: str):
    """Train (and test) on ``device`` in this process: alone, or as one rank
    of the process group it has joined. Returns the final TrainState."""
    from ..data.datamodule import Valentini_Module, WSJ0_mix_Module
    from ..model import DiffSepModel
    from ..train.loop import fit

    trainer_cfg = cfg.get("trainer") or {}
    run_dir = make_run_dir(cfg, overrides)
    log.info("run dir: %s", run_dir)
    # pad batch lengths to whole seconds, as the JAX package does
    module = Valentini_Module if cfg.name == "enhancement" else WSJ0_mix_Module
    dm = module(cfg, pad_to_multiple=int(cfg.model.fs))

    init_params = init_ema = None
    lp = cfg.get("load_pretrained")
    if lp:
        # warm start: the pretrained run's score_model architecture, its
        # weights, and a fresh optimizer
        log.info("load pretrained: %s", lp)
        score_cfg, init_params, init_ema = load_pretrained(Path(lp))
        cfg.model.score_model = ConfigNode.wrap(dict(score_cfg))

    seed = int(cfg.get("seed", 0))
    model = DiffSepModel(cfg, device=device, seed=seed)
    state = None
    if cfg.get("train", True):
        state = fit(
            model, dm, run_dir, cfg, seed=seed,
            resume=(trainer_cfg.get("resume_from_checkpoint") or cfg.get("resume_from_checkpoint") or False),
            init_params=init_params, init_ema_params=init_ema,
        )
        if state.preempted:
            # the checkpoint is saved; the grace period has no time for the
            # test split: resume with trainer.resume_from_checkpoint=latest
            log.warning("preempted: skipping the test evaluation")
            return state
    if cfg.get("test", False):
        from .evaluate import evaluate_datamodule

        if state is None:
            log.warning("test=true with train=false: evaluating freshly initialized weights")
            state = model.init_state()
        evaluate_datamodule(model, state, dm, run_dir / "test_results")
    return state


if __name__ == "__main__":
    main()
