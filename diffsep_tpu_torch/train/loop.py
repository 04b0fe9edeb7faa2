"""The fit loop: epochs, validation, logging, checkpoints, resume,
preemption.

Counterpart of ``diffsep_tpu/train/loop.py``:
  * ``hparams.yaml`` (the composed config) in the run dir;
  * scalars at the JAX package's cadence, to tensorboard where tensorboardX
    is importable, else nowhere: train/score_loss every ``log_every``
    micro-steps, grad/norm, grad/clipped_norm and grad/step_size every
    ``grad_log_every``, val/score_loss and the model's validation metrics
    (val/si_sdr; val/pesq for enhancement) after each validation;
  * ``train_log.jsonl``: every micro-step's loss, gradient norms, learning
    rate and the host clock at its start, written at the end of each epoch
    (after a ``torch.cuda.synchronize()``, whose time it records as
    ``synced_s``), so no micro-step waits for the card to report;
  * checkpoints with top-k by ``model.main_val_loss``, best-model and
    latest symlinks, resume and warm start;
  * preemption (``trainer.preempt_save``, on by default): SIGTERM sets a
    flag, the ranks agree on it (an all-reduce every
    ``trainer.preempt_sync_every`` micro-steps; one process looks every
    micro-step), then the run saves a checkpoint at once, without metrics
    and without validation, and stops; ``resume_from_checkpoint=latest``
    goes on from it;
  * ``trainer.profiler: true``: a ``torch.profiler`` trace of the run under
    ``<run dir>/profile/``, one file per rank;
  * ``trainer.deterministic: true``: cuDNN (the conv's backward) in its
    deterministic algorithms, benchmarking off; the hand kernels use no
    atomics.

Data parallelism (``parallel/mesh.py``): every rank holds rank 0's state
(``replicate_global``) and trains its loader shard through the DDP wrapper;
rank 0 alone writes hparams, tensorboard, ``train_log.jsonl`` and the
checkpoints, into the run dir all ranks share, and every rank passes a
barrier after each save. Every rank validates on the whole validation
split, as the JAX package's processes do, and all take rank 0's metrics, so
they agree on "best".

``trainer.strategy: fsdp`` (the JAX package's ``fsdp_shardings``) shards
the parameters of at least ``trainer.fsdp_min_size`` elements (default
2**16), their gradients, Adam moments, accumulator and EMA over the ranks
instead of replicating them (``mesh.shard_fsdp``, ``trainer.shard_state``).
Batches are DDP's: each rank takes ``batch_size`` rows of its shard. Every
rank runs each validation forward, since each gathers the parameters from
all; the checkpoint holds the whole tensors, gathered by every rank and
written by rank 0, as a DDP run's; and ``fit`` returns a one-process model
and state, so ``test=true`` goes on as after DDP.

Left out: ``pad_batch_for_tpu``, which exists for a TPU layout (a batch of
6 runs as it is here).
"""
from __future__ import annotations

import contextlib
import json
import logging
import signal
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import yaml

from ..config.compose import to_dict
from ..parallel import mesh
from ..utils.distributed import is_rank_zero
from .checkpoints import CheckpointManager, load_payload
from .ema import swapped
from .trainer import TrainState, shard_state, step_generator

log = logging.getLogger(__name__)


class Logger:
    """Scalars to tensorboard (tensorboardX) when it is importable."""

    def __init__(self, logdir):
        self.writer = None
        if logdir is not None:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self.writer = SummaryWriter(str(logdir))

    def log_metrics(self, metrics, step):
        if self.writer is None:
            return
        for k, v in metrics.items():
            self.writer.add_scalar(k, float(v), int(step))

    def close(self):
        if self.writer is not None:
            self.writer.close()


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch on ``device``: pinned and copied without blocking the
    host, for the card."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _resume_path(resume, ckpt: CheckpointManager) -> Optional[Path]:
    """The checkpoint file ``trainer.resume_from_checkpoint`` names: True or
    "latest" (this run's latest, or None when it has none yet), a run dir,
    a checkpoints dir or a checkpoint file."""
    if resume is True or resume == "latest":
        step = ckpt.latest_step()
        return ckpt.path(step) if step is not None else None
    src = Path(resume).expanduser()
    if (src / "checkpoints").is_dir():
        src = src / "checkpoints"
    if src.is_dir():
        src = src / "latest.pt"
    if not src.exists():
        raise FileNotFoundError(f"resume_from_checkpoint: {resume} not found")
    return src.resolve()


def restore(model, state, payload: dict) -> None:
    """Model parameters and train state from a checkpoint's payload."""
    model.score_model.load_state_dict(payload["model"], strict=True)
    state.load_state_dict(payload["train_state"])


def whole_model_state(model, state: TrainState) -> dict:
    """The score model's state dict with whole tensors: under fsdp every
    sharded parameter gathered from the ranks (every rank calls)."""
    sd = model.score_model.state_dict()
    if state.fsdp is not None:
        for i, name in enumerate(state.names):
            sd[name] = state.fsdp.gather(state.fsdp.local[i], i)
    return sd


def unshard(model, state: TrainState) -> TrainState:
    """After fsdp training: ``model`` holds a one-process score model with
    the whole parameters again, and the returned state the whole optimizer
    state and EMA, as after DDP (every rank calls)."""
    from ..model import build_score_model

    weights, payload = whole_model_state(model, state), state.state_dict()
    score_model = build_score_model(model.config).to(model.device).eval()
    score_model.load_state_dict(weights, strict=True)
    model.score_model = score_model
    whole = model.init_state()
    whole.load_state_dict(payload)
    return whole


def _flush(records, workdir: Path, t_fit: float) -> None:
    """Append the pending micro-steps to train_log.jsonl, after the card has
    finished them."""
    if not records:
        return
    device = records[0][2]["train/score_loss"].device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    synced = time.perf_counter()
    keys = ("train/score_loss", "grad/norm", "grad/clipped_norm")
    values = torch.stack([torch.stack([m[k].float() for k in keys]) for _, _, m in records]).cpu().tolist()
    with open(workdir / "train_log.jsonl", "a") as f:
        for (step, t, m), vals in zip(records, values):
            f.write(json.dumps(dict(step=step, start_s=t, lr=m["lr"], **dict(zip(keys, vals)))) + "\n")
        f.write(json.dumps({"synced_s": synced - t_fit}) + "\n")
    records.clear()


class _PreemptFlag:
    """Set by SIGTERM while installed (the main thread only: elsewhere
    ``signal.signal`` raises, and the flag is never set)."""

    def __init__(self):
        self.set = False
        self._prev = None

    def _on_signal(self, signum, frame):
        self.set = True
        log.warning("received signal %d: checkpointing and stopping at the next step boundary", signum)

    def __enter__(self):
        try:
            self._prev = signal.signal(signal.SIGTERM, self._on_signal)
        except ValueError:  # not the main thread
            self._prev = None
        return self

    def __exit__(self, *exc):
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)

    def agreed(self, step: int, sync_every: int) -> bool:
        """Whether to stop now. The ranks must agree before the save (the
        signal may reach one of them only), so under data parallelism they
        all-reduce the flag at the same micro-steps, every ``sync_every``."""
        if mesh.world_size() == 1:
            return self.set
        if step % sync_every != 0:
            return False
        return mesh.any_rank(self.set)


@contextlib.contextmanager
def _cudnn_deterministic(on: bool):
    """cuDNN's deterministic algorithms and no benchmarking inside the
    block where ``on``; the process's settings after it."""
    if not on:
        yield
        return
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


@contextlib.contextmanager
def _profiled(on: bool, device: torch.device, out_dir: Path):
    """A ``torch.profiler`` trace of the block, written to
    ``out_dir/trace_rank<r>.json`` after it, where ``on``."""
    if not on:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        yield
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / f"trace_rank{mesh.rank()}.json"))


def fit(model, datamodule, workdir, config, seed: int = 0, max_epochs: Optional[int] = None,
        max_steps: Optional[int] = None, resume=False, log_every: int = 10, grad_log_every: int = 25,
        state=None, init_params=None, init_ema_params=None):
    """Train ``model`` on ``datamodule``; ``config`` is the composed tree
    (its ``trainer`` node sets epochs, steps, validation, preemption,
    profiling and determinism). Under a process group of several ranks
    every rank calls it, with the same arguments and the run dir they share.
    Returns the final TrainState (``preempted`` set where SIGTERM stopped
    it)."""
    workdir = Path(workdir)
    rank_zero = is_rank_zero()
    if rank_zero:
        workdir.mkdir(parents=True, exist_ok=True)
        with open(workdir / "hparams.yaml", "w") as f:
            yaml.safe_dump({"config": to_dict(config)}, f)
    mesh.barrier()

    cfg_trainer = config.get("trainer", {}) or {}
    if max_epochs is None:
        max_epochs = int(cfg_trainer.get("max_epochs", 1000))
    if max_steps is None and cfg_trainer.get("max_steps") is not None:
        max_steps = int(cfg_trainer["max_steps"])
    check_val_every_n_epoch = int(cfg_trainer.get("check_val_every_n_epoch", 1))
    preempt_save = bool(cfg_trainer.get("preempt_save", True))
    preempt_sync_every = max(int(cfg_trainer.get("preempt_sync_every", 25)), 1)
    anomaly = torch.autograd.detect_anomaly() if cfg_trainer.get("detect_anomaly", False) else contextlib.nullcontext()

    logger = Logger(workdir / "tb" if rank_zero else None)
    ckpt = CheckpointManager(
        workdir / "checkpoints", max_to_keep=20,
        monitor=model.config.get("main_val_loss", "val/si_sdr"),
        mode=model.config.get("main_val_loss_mode", "max"),
    )
    if state is None:
        if init_params is not None:
            # warm start: pretrained weights, fresh optimizer, step and clip state
            model.score_model.load_state_dict(init_params, strict=True)
        state = model.init_state()
        if init_ema_params is not None:
            state.ema.load_state_dict({"params": init_ema_params, "num_updates": 0}, state.names)
        path = _resume_path(resume, ckpt) if resume else None
        if path is not None:
            restore(model, state, load_payload(path))
            log.info("resumed from %s at step %d", path, state.step)
        elif resume:
            log.warning("resume requested but %s has no checkpoint yet; starting fresh", ckpt.directory)
    mesh.replicate_global(state)

    device = model.device
    # any other strategy (ddp; the JAX package's dp_mesh) is data parallel,
    # as in the JAX package
    if cfg_trainer.get("strategy") == "fsdp" and mesh.world_size() > 1:
        min_size = int(cfg_trainer.get("fsdp_min_size", 2 ** 16))
        shard_state(state, mesh.shard_fsdp(model.score_model, state.names, min_size))
        forward = model.score_model
    else:
        forward = mesh.wrap_ddp(model.score_model, device)
    train_step = model.make_train_step(seed, forward=forward)
    val_loss_fn = model.make_val_loss(seed + 1)
    train_loader = datamodule.train_dataloader()
    step = state.step
    stop = preempted = False
    records = []  # (step, host start, metrics) not yet in train_log.jsonl

    def save(metrics):
        payload = {"model": whole_model_state(model, state), "train_state": state.state_dict()}
        if rank_zero:
            ckpt.save(step, {**payload, "config": to_dict(config)}, metrics)
        mesh.barrier()

    preempt = _PreemptFlag() if preempt_save else None
    t_fit = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(_cudnn_deterministic(bool(cfg_trainer.get("deterministic", False))))
        stack.enter_context(_profiled(bool(cfg_trainer.get("profiler", False)), device, workdir / "profile"))
        stack.enter_context(anomaly)
        if preempt is not None:
            stack.enter_context(preempt)
        for epoch in range(max_epochs):
            for mix, target in train_loader:
                t = time.perf_counter()
                metrics = train_step(state, to_device(mix, device), to_device(target, device))
                step += 1
                records.append((step, t - t_fit, metrics))
                if step % log_every == 0:
                    logger.log_metrics({"train/score_loss": metrics["train/score_loss"]}, step)
                if step % grad_log_every == 0:
                    logger.log_metrics({k: metrics[k] for k in ("grad/norm", "grad/clipped_norm",
                                                                 "grad/step_size")}, step)
                if max_steps is not None and step >= max_steps:
                    stop = True
                    break
                if preempt is not None and preempt.agreed(step, preempt_sync_every):
                    stop = preempted = True
                    break
            if rank_zero:
                _flush(records, workdir, t_fit)
            records.clear()
            if preempted:
                # the grace period is short: save now, without validation; a
                # checkpoint without metrics never becomes best-model
                save({})
                log.warning("preemption checkpoint saved at step %d", step)
            elif (epoch + 1) % check_val_every_n_epoch == 0 or stop:
                val_metrics = mesh.broadcast_object(validate(model, datamodule, state, val_loss_fn, seed + 2))
                log.info("step %d: %s", step, val_metrics)
                logger.log_metrics(val_metrics, step)
                save(val_metrics)
            if stop:
                break
    logger.close()
    if state.fsdp is not None:
        state = unshard(model, state)
    state.preempted = preempted
    return state


def validate(model, datamodule, state, val_loss_fn, sep_seed: int) -> dict:
    """Score loss over the validation loader and separation metrics on its
    first ``valid_max_sep_batches`` batches, all with the EMA weights. A
    metric that raises on a batch is logged and left out of its mean; one
    that scored no batch is left out of the result."""
    losses = []
    sep_metrics = {name: [] for name in model.val_losses}
    with swapped(state.ema, state.params):
        for i, (mix, target) in enumerate(datamodule.val_dataloader()):
            mix, target = to_device(mix, model.device), to_device(target, model.device)
            losses.append(val_loss_fn(mix, target, i))
            if i < model.valid_max_sep_batches:
                est, _ = model.separate(mix, generator=step_generator(sep_seed, i, mix.device))
                for name, loss in model.val_losses.items():
                    try:
                        sep_metrics[name].append(float(loss(est, target)))
                    except Exception as e:  # noqa: BLE001
                        # a metric never ends training (PESQ raises on a
                        # clip under 250 ms or a silent one): logged, and
                        # left out of this validation's mean
                        log.warning("val metric %s failed: %s", name, e)
    out = {"val/score_loss": float(torch.stack(losses).mean())}
    out.update({name: float(np.mean(vals)) for name, vals in sep_metrics.items() if vals})
    return out
