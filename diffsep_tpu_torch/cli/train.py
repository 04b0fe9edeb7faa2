"""Training entry point.

    python -m diffsep_tpu_torch.cli.train experiment=icassp-separation \\
        path.datasets.wsj0_mix=/data/wsj0_mix [trainer.max_steps=N] [...]
    python -m diffsep_tpu_torch.cli.train experiment=noise-reduction \\
        path.datasets.valentini=/data/VCTK_DEMAND test=true [...]

Counterpart of ``diffsep_tpu/cli/train.py``: the composed config with
dotted overrides, the run dir ``<path.exp_root>/<name>/<timestamp>_<overrides>/``,
the seed, the datamodule by experiment name (``enhancement``: VCTK-DEMAND,
else WSJ0-mix), ``trainer.resume_from_checkpoint`` (or the top-level
``resume_from_checkpoint``), ``load_pretrained``, and ``test=true``, which
scores the test split with the EMA weights after training
(``cli/evaluate.py``: ``<run dir>/test_results/test.json``; with
``train=false``, freshly initialized weights). It trains on one CUDA device
(``trainer.accelerator: gpu``) unless ``trainer.accelerator=cpu`` asks for
the CPU.
"""
from __future__ import annotations

import datetime
import hashlib
import logging
import sys
from pathlib import Path

from ..config import ConfigNode, compose

log = logging.getLogger(__name__)

DEVICES = {"gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}


def make_run_dir(cfg, overrides) -> Path:
    ts = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
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


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg = compose(overrides)
    trainer_cfg = cfg.get("trainer") or {}
    accelerator = trainer_cfg.get("accelerator", "gpu")
    if accelerator not in DEVICES:
        raise ValueError(f"trainer.accelerator={accelerator!r}: expected one of {sorted(DEVICES)}")
    if int(trainer_cfg.get("devices", 1)) != 1:
        raise NotImplementedError("diffsep_tpu_torch trains on one device (trainer.devices=1)")

    from ..data.datamodule import Valentini_Module, WSJ0_mix_Module
    from ..model import DiffSepModel
    from ..train.loop import fit

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
    model = DiffSepModel(cfg, device=DEVICES[accelerator], seed=seed)
    state = None
    if cfg.get("train", True):
        state = fit(
            model, dm, run_dir, cfg, seed=seed,
            resume=(trainer_cfg.get("resume_from_checkpoint") or cfg.get("resume_from_checkpoint") or False),
            init_params=init_params, init_ema_params=init_ema,
        )
    if cfg.get("test", False):
        from .evaluate import evaluate_datamodule

        if state is None:
            log.warning("test=true with train=false: evaluating freshly initialized weights")
            state = model.init_state()
        evaluate_datamodule(model, state, dm, run_dir / "test_results")
    return state


if __name__ == "__main__":
    main()
