"""Folder-to-folder separation: every ``*.wav`` of the input folder is
separated and each source written to ``<output>/s<i>/<name>.wav``.

    python -m diffsep_tpu_torch.cli.separate IN_DIR OUT_DIR --model RUN_DIR

Counterpart of ``diffsep_tpu/cli/separate.py``. ``--model`` is a run dir of
``diffsep_tpu_torch.cli.train`` (its EMA weights), one of its checkpoints,
or a reference Lightning checkpoint (``cli/loading.py``); a sampler that
the run's config pins (a distilled stage, ``cli/distill.py``) is the
default. It may also be an export artifact of the port
(``cli/export_model.py``): the files then go through the serving engine's
``ArtifactEngine`` at the artifact's static batch and length, with the
sampler baked in at export. Each file is
normalized on its true length, zero-padded to whole seconds (the length
bucket of the serving engine), separated by the PC sampler, cut back to its
length, and the raw mixture is projected onto the estimates
(``scale_output``). ``--stream-chunk-s`` separates in fixed chunks instead
(``streaming.py``). It runs on CUDA unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..data.audio_io import load_wav, save_wav
from ..train.losses import normalize_batch
from ..train.trainer import step_generator
from .eval_common import apply_pinned_sampler, reject_baked_flags, sampler_flag_map, str2bool
from .loading import load_model

DEFAULT_MODEL = "fakufaku/diffsep"
# the first bytes of an export artifact of the JAX package (diffsep_tpu/export.py),
# which the port does not serve (its own artifacts start with export._MAGIC)
ARTIFACT_MAGIC = b"DSEXP01\n"

log = logging.getLogger(__name__)


def resolve_model_path(model) -> Path:
    """The local path of ``--model``. The JAX package downloads a name that is
    not a local path from the HuggingFace Hub; the port has no download, so
    it says how to get the checkpoint."""
    model = Path(model)
    if model.exists():
        return model
    raise FileNotFoundError(
        f"Model '{model}' is not a local path. Download the checkpoint "
        f"('{DEFAULT_MODEL}', file checkpoint.pt) where there is network access "
        "and pass its path via --model."
    )


def reject_artifact(path: Path) -> None:
    """An export artifact of the JAX package (StableHLO) is not served by the
    port, which serves its own."""
    try:
        with open(path, "rb") as f:
            is_artifact = f.read(len(ARTIFACT_MAGIC)) == ARTIFACT_MAGIC
    except (IsADirectoryError, OSError):
        return
    if is_artifact:
        raise NotImplementedError(
            f"{path} is an export artifact of the JAX package (StableHLO): not ported to diffsep_tpu_torch "
            "(ROADMAP.md, queue 1 item 4, the export artifact); export the checkpoint with "
            "diffsep_tpu_torch.cli.export_model and serve that")


def scale_output(mix: np.ndarray, sep: np.ndarray) -> np.ndarray:
    """Project the mixture onto each separated signal."""
    num = (mix * sep).sum(axis=-1, keepdims=True)
    denom = (sep * sep + 1e-10).sum(axis=-1, keepdims=True)
    return num / denom * sep


def separate_with_artifact(path: Path, args, device) -> None:
    """The folder through an export artifact of the port, batched by the
    serving engine (same ``s<i>/<stem>.wav`` layout); a file that the
    artifact cannot take (another rate, longer than its length) is skipped
    with a warning."""
    from ..export import load_separator
    from .serve import ArtifactEngine

    reject_baked_flags({**sampler_flag_map(args), "--stream-chunk-s": args.stream_chunk_s,
                        "--avg-last-k": args.avg_last_k},
                       "not available with an export artifact: sampler settings are baked at export time "
                       "(cli/export_model.py) and streaming needs a live model")
    eng = ArtifactEngine(load_separator(path, device=device), seed=args.seed)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    for wavpath, ok, msg in eng.process(sorted(args.input_dir.glob("*.wav")), args.output_dir):
        if not ok:
            log.warning("skipping %s: %s", wavpath.name, msg)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Separate all the wav files in a folder")
    parser.add_argument("input_dir", type=Path)
    parser.add_argument("output_dir", type=Path)
    parser.add_argument("--model", type=Path, default=Path(DEFAULT_MODEL),
                        help="run dir, checkpoint file, or reference .ckpt")
    parser.add_argument("-N", type=int, default=None, help="number of steps")
    parser.add_argument("--snr", type=float, default=None, help="corrector snr")
    parser.add_argument("--corrector-steps", type=int, default=None, help="number of corrector steps")
    parser.add_argument("--denoise", type=str2bool, default=None,
                        help="return the last step's mean (true/false; default true)")
    parser.add_argument("-s", "--schedule", default=None, help="time grid: linear, log or revlog")
    parser.add_argument("--predictor", default=None,
                        help="default reverse_diffusion; ddim/dpmpp for the fast samplers")
    parser.add_argument("--corrector", default=None, help="default ald2; none with ddim/dpmpp")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--avg-last-k", type=int, default=None,
                        help="average the evaluation weights of the k most recent checkpoints (run dirs)")
    parser.add_argument("--stream-chunk-s", type=float, default=None,
                        help="separate in fixed chunks of this many seconds, stitched with "
                        "permutation alignment and a crossfade (streaming.py)")
    parser.add_argument("--stream-overlap-s", type=float, default=0.5,
                        help="chunk overlap for --stream-chunk-s")
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    model_path = resolve_model_path(args.model)
    from .serve import _is_artifact

    if _is_artifact(model_path):
        separate_with_artifact(model_path, args, device)
        return
    reject_artifact(model_path)
    model = load_model(model_path, avg_last_k=args.avg_last_k, device=device)
    apply_pinned_sampler(args, model.config)
    fs_model = int(model.config["fs"])
    predictor = args.predictor or "reverse_diffusion"
    corrector = args.corrector or "ald2"
    kw = {k: v for k, v in (("N", args.N), ("snr", args.snr), ("corrector_steps", args.corrector_steps),
                            ("schedule", args.schedule)) if v is not None}
    kw["denoise"] = True if args.denoise is None else args.denoise
    args.output_dir.mkdir(parents=True, exist_ok=True)

    for i, wavpath in enumerate(sorted(args.input_dir.glob("*.wav"))):
        mix, fs = load_wav(wavpath)
        if fs != fs_model:
            log.warning("skipping %s: %d Hz, the model expects %d Hz", wavpath.name, fs, fs_model)
            continue
        mix = mix[:1][None]  # (1, 1, T)
        if args.stream_chunk_s is not None:
            from ..streaming import separate_streaming

            est = separate_streaming(
                model, mix[0], chunk_s=args.stream_chunk_s, overlap_s=args.stream_overlap_s,
                generator=step_generator(args.seed, i, device), predictor_name=predictor,
                corrector_name=corrector, **kw,
            )[None]
        else:
            # normalized on the true length, then padded to whole seconds;
            # the raw mixture is projected onto estimates in the normalized
            # domain (scale_output absorbs the std; the mean is not added back)
            (mix_n, _), _, _ = normalize_batch(torch.from_numpy(mix))
            n = mix.shape[-1]
            padded = -(-n // fs_model) * fs_model
            sampler = model.get_pc_sampler(
                predictor, corrector, torch.nn.functional.pad(mix_n, (0, padded - n)),
                generator=step_generator(args.seed, i, device), **kw)
            est = sampler()[0][..., :n].float().cpu().numpy()
        est = scale_output(mix, est)
        for src in range(est.shape[1]):
            save_wav(args.output_dir / f"s{src}" / f"{wavpath.stem}.wav", est[0, src:src + 1], fs)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
