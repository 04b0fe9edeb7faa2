"""Progressive distillation entry point.

    python -m diffsep_tpu_torch.cli.distill RUN_DIR --stages 8,4,2 --steps 5000 --out OUT

Counterpart of ``diffsep_tpu/cli/distill.py``. The teacher is any
checkpoint that ``cli/loading.py`` loads, with its EMA weights; batches come
from the run's own datamodule (WSJ0-mix, or VCTK-DEMAND for the
enhancement recipe), cycled. Each stage (``train/distill.py``) writes a run
dir of the port, ``<out>/N<n>/``: ``hparams.yaml`` whose
``model.sampler`` pins ``ddim``/``none``/N=n (and the schedule), and
``checkpoints/`` with the student's train state and its EMA. So
``cli.separate``, ``cli.serve``, ``cli.evaluate`` and ``cli.export_model``
load a stage and sample at its N without sampler flags; their flags still
override. It runs on CUDA unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import logging
import sys
from pathlib import Path

log = logging.getLogger(__name__)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ckpt", type=Path, help="teacher: run dir, checkpoint file or reference .ckpt")
    ap.add_argument("--stages", default="8,4,2", help="comma-separated halving schedule of serving Ns")
    ap.add_argument("--steps", type=int, default=5000, help="optimizer steps per stage")
    ap.add_argument("--teacher-substeps", type=int, default=2)
    ap.add_argument("--on-policy-frac", type=float, default=0.0,
                    help="fraction of inputs taken from the student's own sampler trajectory "
                         "(N - 1 more evaluations per step)")
    ap.add_argument("--schedule", default=None, choices=[None, "linear", "log", "revlog"],
                    help="time grid (pc_sample's): students are distilled and served on it")
    ap.add_argument("--lr", type=float, default=None, help="learning rate of the distillation")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None, help="output root (default: <ckpt>/distilled)")
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    import yaml

    from .. import resolve_device
    from ..config import ConfigNode
    from ..data.datamodule import Valentini_Module, WSJ0_mix_Module
    from ..train.checkpoints import CheckpointManager
    from ..train.distill import DistillConfig, distill_stage, ema_state_dict, stage_seed
    from ..train.loop import to_device
    from .loading import load_model

    stages = tuple(int(s) for s in str(args.stages).split(","))
    model = load_model(args.ckpt, device=resolve_device(args.device))
    if model.run_config is None:
        raise ValueError(f"{args.ckpt} holds no run config: distillation reads the run's datamodule")
    if args.lr is not None:
        model.optim_cfg = dataclasses.replace(model.optim_cfg, lr=float(args.lr))
    out_root = args.out or ((args.ckpt if args.ckpt.is_dir() else args.ckpt.parent) / "distilled")
    out_root.mkdir(parents=True, exist_ok=True)

    cfg = ConfigNode.wrap(model.run_config)
    module = Valentini_Module if cfg.name == "enhancement" else WSJ0_mix_Module
    loader = module(cfg, pad_to_multiple=int(model.config["fs"])).train_dataloader()

    def batches():
        while True:
            for mix, tgt in loader:
                yield to_device(mix, model.device), to_device(tgt, model.device)

    batch_iter = batches()
    for si, n in enumerate(stages):
        dcfg = DistillConfig(n_student=n, t_eps=model.t_eps, schedule=args.schedule,
                             teacher_substeps=args.teacher_substeps,
                             source_order=model.loss_cfg.train_source_order, on_policy_frac=args.on_policy_frac)
        log.info("stage N=%d: %d steps", n, args.steps)
        state = distill_stage(model, lambda step: next(batch_iter), dcfg, args.steps, stage_seed(args.seed, si),
                              args.log_every)

        # a run dir of its own, its sampler pinned to the student's N
        stage_dir = out_root / f"N{n}"
        stage_dir.mkdir(parents=True, exist_ok=True)
        stage_cfg = copy.deepcopy(model.run_config)
        stage_cfg["model"]["sampler"] = {"predictor_name": "ddim", "corrector_name": "none", "N": n}
        if args.schedule:
            stage_cfg["model"]["sampler"]["schedule"] = args.schedule
        with open(stage_dir / "hparams.yaml", "w") as f:
            yaml.safe_dump({"config": stage_cfg}, f)
        ckpt = CheckpointManager(stage_dir / "checkpoints")
        ckpt.save(state.step, {"model": model.score_model.state_dict(), "train_state": state.state_dict(),
                               "config": stage_cfg})
        log.info("stage N=%d saved to %s", n, stage_dir)
        # the next stage's teacher: this one's EMA weights
        model.score_model.load_state_dict(ema_state_dict(model, state), strict=True)

    print(str(out_root))
    return 0


if __name__ == "__main__":
    sys.exit(main())
