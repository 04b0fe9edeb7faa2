"""Model and checkpoint loading shared by the inference CLIs.

Counterpart of ``diffsep_tpu/cli/loading.py`` on the port's run-dir layout
(``diffsep_tpu_torch.cli.train``: ``hparams.yaml``, ``checkpoints/<step>.pt``,
``index.json``, ``best-model.pt``, ``latest.pt``). A checkpoint is given as
  * a run dir: its best checkpoint by the monitored metric, else its latest;
  * its ``checkpoints`` dir (the same), or one checkpoint file in it, which
    pins the step;
  * a checkpoint file of the port on its own (it holds its config), or a
    weights file: ``{"state_dict": ..., "config": overrides}`` or a bare
    state dict of the flagship;
  * a reference Lightning checkpoint (``.ckpt``/``.pt``): ``score_model.*``
    weights in the port's layout, the EMA shadow list, and
    ``hyper_parameters.config`` with the reference's ``_target_`` paths.
``load_model`` returns a ``DiffSepModel`` holding the evaluation weights:
the EMA ones where the checkpoint has them, unless ``use_ema=False``.
"""
from __future__ import annotations

import copy
import logging
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch
import yaml

from ..model import DiffSepModel
from ..models.convert import FROM_REFERENCE_TARGETS, state_dicts_from_reference
from ..train.checkpoints import CheckpointManager

log = logging.getLogger(__name__)

def _config_from_hparams(hparams) -> Optional[Dict[str, Any]]:
    """The config of a run's ``hparams.yaml`` or a reference checkpoint's
    ``hyper_parameters``, with the reference's ``_target_`` paths naming the
    port's classes; None where there is none (the flagship's defaults)."""
    cfg = hparams.get("config", hparams) if hparams else None

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                out[k] = FROM_REFERENCE_TARGETS.get(v, v) if k == "_target_" else walk(v)
            return out
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return node

    return walk(copy.deepcopy(dict(cfg))) if cfg else None


def read_checkpoint(path) -> Tuple[Optional[Dict[str, Any]], dict, Optional[dict]]:
    """(config, raw state dict, EMA state dict or None) of one checkpoint
    file: the port's, or a reference Lightning checkpoint. Reference
    checkpoints pickle their hyper-parameters, so this unpickles arbitrary
    objects, as the JAX package does: load only checkpoints you trust."""
    blob = torch.load(str(path), map_location="cpu", weights_only=False)
    if "train_state" in blob:  # written by diffsep_tpu_torch.train.loop.fit
        return blob["config"], blob["model"], blob["train_state"]["ema"]["params"]
    if "state_dict" in blob and "hyper_parameters" not in blob and "config" in blob:
        # the port's own weights file: {"state_dict": ..., "config": overrides}
        return blob["config"], blob["state_dict"], None
    if "state_dict" in blob:
        raw, ema = state_dicts_from_reference(blob)
        return _config_from_hparams(blob.get("hyper_parameters")), raw, ema
    if blob and all(isinstance(v, torch.Tensor) for v in blob.values()):
        return None, blob, None  # a bare state dict of the flagship
    raise ValueError(f"{path}: neither a diffsep_tpu_torch checkpoint nor a reference Lightning checkpoint")


def _resolve_run_dir(ckpt: Path, step: Optional[int]):
    """A run dir, its checkpoints dir or a checkpoint file in it -> (run
    dir, step); a checkpoint file (or a symlink to one) pins its step."""
    if (ckpt / "hparams.yaml").exists():
        return ckpt, step
    if ckpt.is_dir() and (ckpt.parent / "hparams.yaml").exists():
        return ckpt.parent, step
    if (ckpt.parent.parent / "hparams.yaml").exists():
        stem = ckpt.resolve().stem
        if step is None and stem.isdigit():
            step = int(stem)
        return ckpt.parent.parent, step
    raise FileNotFoundError(f"no hparams.yaml found near {ckpt}")


def resolve_avg_steps(ckpt, avg_last_k: int, step: Optional[int] = None) -> list:
    """The checkpoint steps ``load_model(avg_last_k=k, step=step)`` averages:
    the k most recent, only those at or before ``step`` when it is given.
    Fewer than k where fewer exist, so a result tag can name the number
    actually averaged."""
    run_dir, step = _resolve_run_dir(Path(ckpt), step)
    steps = sorted(int(p.stem) for p in (run_dir / "checkpoints").glob("*.pt") if p.stem.isdigit())
    if step is not None:
        steps = [s for s in steps if s <= step]
        if not steps:
            raise FileNotFoundError(f"no checkpoints at or before step {step} in {run_dir}")
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {run_dir}")
    return steps[-avg_last_k:]


def load_model(ckpt, step: Optional[int] = None, use_ema: bool = True,
               avg_last_k: Optional[int] = None, device=None) -> DiffSepModel:
    """The model of any checkpoint flavor, on ``device`` (CUDA unless
    given), holding the evaluation weights. ``avg_last_k=k`` holds the mean
    of the k most recent checkpoints' weights (of a run dir; an explicit
    step, as argument or checkpoint file, anchors the window)."""
    ckpt = Path(ckpt)
    try:
        run_dir, step = _resolve_run_dir(ckpt, step)
    except FileNotFoundError:
        if not ckpt.is_file():
            raise
        if avg_last_k and avg_last_k > 1:
            raise ValueError("avg_last_k needs a run directory with several checkpoints; "
                             f"{ckpt} is a single one") from None
        config, raw, ema = read_checkpoint(ckpt)
        return _with_weights(DiffSepModel(config, device=device), raw, ema, use_ema)

    config = _config_from_hparams(yaml.safe_load((run_dir / "hparams.yaml").read_text()))
    model = DiffSepModel(config, device=device)
    mgr = CheckpointManager(run_dir / "checkpoints", monitor=model.config.get("main_val_loss", "val/si_sdr"),
                            mode=model.config.get("main_val_loss_mode", "max"))
    if not (avg_last_k and avg_last_k > 1):
        if step is None:
            step = mgr.best_step() or mgr.latest_step()
        _, raw, ema = read_checkpoint(mgr.path(step))
        return _with_weights(model, raw, ema, use_ema)

    steps = resolve_avg_steps(run_dir, avg_last_k, step=step)
    if len(steps) < avg_last_k:
        log.warning("avg_last_k=%d but only %d checkpoints exist; averaging %d",
                    avg_last_k, len(steps), len(steps))
    acc = None
    for s in steps:
        _, raw, ema = read_checkpoint(mgr.path(s))
        weights = ema if use_ema else raw
        acc = {k: v.double() for k, v in weights.items()} if acc is None else {
            k: acc[k] + v.double() for k, v in weights.items()}
    mean = {k: (v / len(steps)).float() for k, v in acc.items()}
    return _with_weights(model, mean, None, use_ema=False)


def _with_weights(model: DiffSepModel, raw: dict, ema: Optional[dict], use_ema: bool) -> DiffSepModel:
    if use_ema and ema is not None:
        log.info("using the EMA weights")
    model.score_model.load_state_dict(ema if use_ema and ema is not None else raw, strict=True)
    return model
