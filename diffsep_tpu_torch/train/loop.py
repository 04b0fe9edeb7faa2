"""The fit loop: epochs, validation, logging, checkpoints, resume.

Counterpart of ``diffsep_tpu/train/loop.py`` on one device:
  * ``hparams.yaml`` (the composed config) in the run dir;
  * scalars at the JAX package's cadence, to tensorboard where tensorboardX
    is importable, else nowhere: train/score_loss every ``log_every``
    micro-steps, grad/norm, grad/clipped_norm and grad/step_size every
    ``grad_log_every``, val/score_loss and val/si_sdr after each validation;
  * ``train_log.jsonl``: every micro-step's loss, gradient norms, learning
    rate and the host clock at its start, written at the end of each epoch
    (after a ``torch.cuda.synchronize()``, whose time it records as
    ``synced_s``), so no micro-step waits for the card to report;
  * checkpoints with top-k by ``model.main_val_loss``, best-model and
    latest symlinks, resume and warm start.

Left out, as TPU- or JAX-specific: the device mesh and multi-host runs,
the preemption handler, ``pad_batch_for_tpu`` (a batch of 6 runs as it is
here) and the JAX profiler (``trainer.profiler`` raises; the port's
profile is ``scripts/torch_port_profile.py --train``).
"""
from __future__ import annotations

import contextlib
import json
import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import yaml

from ..config.compose import to_dict
from .checkpoints import CheckpointManager, load_payload
from .ema import swapped
from .trainer import step_generator

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


def fit(model, datamodule, workdir, config, seed: int = 0, max_epochs: Optional[int] = None,
        max_steps: Optional[int] = None, resume=False, log_every: int = 10, grad_log_every: int = 25,
        state=None, init_params=None, init_ema_params=None):
    """Train ``model`` on ``datamodule``; ``config`` is the composed tree
    (its ``trainer`` node sets epochs, steps and validation). Returns the
    final TrainState."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    with open(workdir / "hparams.yaml", "w") as f:
        yaml.safe_dump({"config": to_dict(config)}, f)

    cfg_trainer = config.get("trainer", {}) or {}
    if max_epochs is None:
        max_epochs = int(cfg_trainer.get("max_epochs", 1000))
    if max_steps is None and cfg_trainer.get("max_steps") is not None:
        max_steps = int(cfg_trainer["max_steps"])
    if cfg_trainer.get("profiler", False):
        raise NotImplementedError("trainer.profiler: profile with scripts/torch_port_profile.py --train")
    check_val_every_n_epoch = int(cfg_trainer.get("check_val_every_n_epoch", 1))
    anomaly = torch.autograd.detect_anomaly() if cfg_trainer.get("detect_anomaly", False) else contextlib.nullcontext()

    logger = Logger(workdir / "tb")
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

    train_step = model.make_train_step(seed)
    val_loss_fn = model.make_val_loss(seed + 1)
    train_loader = datamodule.train_dataloader()
    device = model.device
    step = state.step
    stop = False
    records = []  # (step, host start, metrics) not yet in train_log.jsonl
    t_fit = time.perf_counter()
    with anomaly:
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
            _flush(records, workdir, t_fit)
            if (epoch + 1) % check_val_every_n_epoch == 0 or stop:
                val_metrics = validate(model, datamodule, state, val_loss_fn, seed + 2)
                log.info("step %d: %s", step, val_metrics)
                logger.log_metrics(val_metrics, step)
                ckpt.save(step, {"model": model.score_model.state_dict(), "train_state": state.state_dict(),
                                 "config": to_dict(config)}, val_metrics)
            if stop:
                break
    logger.close()
    return state


def validate(model, datamodule, state, val_loss_fn, sep_seed: int) -> dict:
    """Score loss over the validation loader and separation metrics on its
    first ``valid_max_sep_batches`` batches, all with the EMA weights."""
    losses = []
    sep_metrics = {name: [] for name in model.val_losses}
    with swapped(state.ema, state.params):
        for i, (mix, target) in enumerate(datamodule.val_dataloader()):
            mix, target = to_device(mix, model.device), to_device(target, model.device)
            losses.append(val_loss_fn(mix, target, i))
            if i < model.valid_max_sep_batches:
                est, _ = model.separate(mix, generator=step_generator(sep_seed, i, mix.device))
                for name, loss in model.val_losses.items():
                    sep_metrics[name].append(float(loss(est, target)))
    out = {"val/score_loss": float(torch.stack(losses).mean())}
    out.update({name: float(np.mean(vals)) for name, vals in sep_metrics.items() if vals})
    return out
