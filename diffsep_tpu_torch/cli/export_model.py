"""Export a trained model to a self-contained serving artifact.

    python -m diffsep_tpu_torch.cli.export_model RUN_DIR -o model.dst \\
        --batch 8 --len-s 5 -N 6 --predictor ddim --corrector none

Counterpart of ``diffsep_tpu/cli/export_model.py``. The artifact
(``export.py``) holds the evaluation (EMA) weights and the whole
separation, sampler included: ``diffsep_tpu_torch.export.load_separator(
"model.dst").call(seed, mix, n_valid)``, ``cli.serve --model model.dst``
and ``cli.separate --model model.dst`` serve it without config,
checkpoint or model code. It is exported on ``--device`` (CUDA unless
``--device cpu``) and serves there. The sampler flags override the
checkpoint's sampler (a distilled stage pins its own). Accepts the
checkpoint flavors of ``cli/loading.py``; ``--avg-last-k K`` exports the
mean of the K most recent checkpoints' evaluation weights.

    python -m diffsep_tpu_torch.cli.export_model RUN_DIR -o model.ckpt --torch

writes a reference Lightning checkpoint instead (no sampler flags: the
reference picks its sampler at run time): the evaluation weights as
``state_dict['score_model.*']`` and the run's config under
``hyper_parameters.config`` with the reference's ``_target_`` paths
(``models/convert.py:save_reference_checkpoint``), which the reference, the
JAX package's loader and the port's read.
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("ckpt", type=Path, help="run dir, checkpoint file or reference .ckpt")
    parser.add_argument("-o", "--output", type=Path, required=True)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--len-s", type=float, default=5.0, help="utterance length in seconds (static shape)")
    parser.add_argument("-N", type=int, default=None, help="sampler steps")
    parser.add_argument("--predictor", default=None)
    parser.add_argument("--corrector", default=None)
    parser.add_argument("--corrector-steps", type=int, default=None)
    parser.add_argument("--snr", type=float, default=None)
    parser.add_argument("--schedule", default=None)
    parser.add_argument("--step", type=int, default=None, help="checkpoint step of a run dir")
    parser.add_argument("--avg-last-k", type=int, default=None,
                        help="average the evaluation weights of the k most recent checkpoints before exporting")
    parser.add_argument("--torch", action="store_true",
                        help="write a reference-compatible PyTorch .ckpt instead of an artifact: the evaluation "
                        "(EMA) weights as state_dict['score_model.*'] and the run config under "
                        "hyper_parameters.config with the reference's _target_ paths")
    parser.add_argument("--device", default=None, help="default: cuda; the artifact serves on this device")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from .. import resolve_device
    from ..config.compose import to_dict
    from .loading import load_model

    kw = {key: v for key, v in (("N", args.N), ("predictor_name", args.predictor),
                                ("corrector_name", args.corrector), ("corrector_steps", args.corrector_steps),
                                ("snr", args.snr), ("schedule", args.schedule)) if v is not None}
    if args.torch:
        from ..models.convert import save_reference_checkpoint
        from .eval_common import reject_baked_flags, sampler_flag_map

        reject_baked_flags(sampler_flag_map(args), "sampler flags do not apply to --torch (the reference "
                                                   "chooses its sampler at run time)")
    model = load_model(args.ckpt, step=args.step, avg_last_k=args.avg_last_k, device=resolve_device(args.device))
    if args.torch:
        config = to_dict(model.run_config) if model.run_config is not None else {"model": dict(model.config)}
        save_reference_checkpoint(args.output, model.score_model.state_dict(), config)
        print(f"wrote reference checkpoint {args.output}")
        return

    from ..export import export_separator

    fs = int(model.config["fs"])
    n_samples = int(round(args.len_s * fs))
    data = export_separator(model, args.batch, n_samples, out_path=args.output, **kw)
    print(f"wrote {args.output} ({len(data) / 1e6:.1f} MB): batch={args.batch} n_samples={n_samples} "
          f"({args.len_s}s @ {fs} Hz) on {model.device.type}")


if __name__ == "__main__":
    main()
