"""Checkpoints with top-k by a monitored metric, a best-model symlink and a
latest symlink.

Counterpart of ``diffsep_tpu/train/checkpoints.py``. A checkpoint is one
file, ``<directory>/<step>.pt``, holding the full training state (model
parameters, EMA shadow and its update count, optimizer moments and
accumulator, clipper history, step) and its metrics; it is written with
``torch.save`` to a temporary file and moved into place with ``os.replace``,
so a crash leaves the old file or the new one, never a torn one. The
metrics of every kept checkpoint are in ``index.json``, written the same
way. The newest checkpoint is never dropped: it is where a run resumes.
"""
from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import Dict, List, Optional

import torch

__all__ = ["CheckpointManager", "atomic_save", "load_payload", "symlink_force"]


def symlink_force(target, link_name) -> None:
    """Point ``link_name`` at ``target``, replacing it in one rename."""
    tmp = str(link_name) + ".tmp"
    try:
        os.remove(tmp)
    except FileNotFoundError:
        pass
    os.symlink(target, tmp)
    os.replace(tmp, link_name)


def atomic_save(obj, path: Path) -> None:
    """``torch.save`` to a temporary file moved into place: a write that
    fails or is cut leaves no file under ``path`` (and no temporary one
    where it fails)."""
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    try:
        torch.save(obj, tmp)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    os.replace(tmp, path)


def load_payload(path: Path, map_location="cpu") -> dict:
    return torch.load(path, map_location=map_location, weights_only=True)


class CheckpointManager:
    def __init__(self, directory, max_to_keep: int = 20, monitor: Optional[str] = "val/si_sdr",
                 mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode}")
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.monitor = monitor
        self.mode = mode
        index = self.directory / "index.json"
        self._metrics: Dict[int, Dict[str, float]] = (
            {int(k): v for k, v in json.loads(index.read_text()).items()} if index.exists() else {})

    def path(self, step: int) -> Path:
        return self.directory / f"{step}.pt"

    def _score(self, step: int) -> float:
        """Larger is better; a checkpoint without the metric ranks last."""
        v = self._metrics[step].get(self.monitor) if self.monitor else None
        if v is None:
            return -math.inf
        return v if self.mode == "max" else -v

    def save(self, step: int, payload: dict, metrics: Optional[Dict[str, float]] = None) -> Path:
        metrics = {k: float(v) for k, v in (metrics or {}).items() if math.isfinite(float(v))}
        path = self.path(step)
        atomic_save(dict(payload, step=step, metrics=metrics), path)
        self._metrics[step] = metrics
        latest = max(self._metrics)
        ranked = sorted(self._metrics, key=lambda s: (self._score(s), s), reverse=True)
        for s in ranked[self.max_to_keep:]:
            if s != latest:
                self.path(s).unlink(missing_ok=True)
                del self._metrics[s]
        tmp = self.directory / f"index.json.{os.getpid()}.tmp"
        tmp.write_text(json.dumps({str(k): v for k, v in sorted(self._metrics.items())}))
        os.replace(tmp, self.directory / "index.json")
        symlink_force(self.path(latest).name, self.directory / "latest.pt")
        best = self.best_step()
        if best is not None:
            symlink_force(self.path(best).name, self.directory / "best-model.pt")
        return path

    def restore(self, step: Optional[int] = None, map_location="cpu") -> dict:
        """The payload of ``step`` (by default the latest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        return load_payload(self.path(step), map_location)

    def latest_step(self) -> Optional[int]:
        return max(self._metrics) if self._metrics else None

    def best_step(self) -> Optional[int]:
        scored = [s for s in self._metrics if self._score(s) > -math.inf]
        return max(scored, key=lambda s: (self._score(s), s)) if scored else None

    def all_steps(self) -> List[int]:
        return sorted(self._metrics)
