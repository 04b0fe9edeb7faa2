"""Folder-to-folder separation: every ``*.wav`` of the input folder is
separated and each source written to ``<output>/s<i>/<name>.wav``.

    python -m diffsep_tpu_torch.cli.separate IN_DIR OUT_DIR --model model.pt

``--model`` is a ``.pt`` file holding the port's state dict, or a dict
``{"state_dict": ..., "config": ...}`` whose config overrides the flagship
model's. The estimates are projected onto the mixture's scale
(``scale_output``) as the reference CLI does.
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np
import torch
from scipy.io import wavfile

from ..model import DiffSepModel
from ..train.losses import normalize_batch

log = logging.getLogger(__name__)


def load_wav(path):
    """(float32 (channels, samples) in [-1, 1], fs)."""
    fs, data = wavfile.read(str(path))
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    else:
        data = data.astype(np.float32)
    data = data[None, :] if data.ndim == 1 else data.T
    return np.ascontiguousarray(data), int(fs)


def save_wav(path: Path, data: np.ndarray, fs: int) -> None:
    """Write one channel of float data as 16-bit PCM."""
    path.parent.mkdir(parents=True, exist_ok=True)
    wavfile.write(str(path), fs, (np.clip(data, -1.0, 1.0) * 32767.0).astype(np.int16))


def scale_output(mix: np.ndarray, sep: np.ndarray) -> np.ndarray:
    """Project the mixture onto each separated signal."""
    num = (mix * sep).sum(axis=-1, keepdims=True)
    denom = (sep * sep + 1e-10).sum(axis=-1, keepdims=True)
    return num / denom * sep


def load_model(path: Path, device) -> DiffSepModel:
    blob = torch.load(str(path), map_location="cpu", weights_only=True)
    config = None
    if "state_dict" in blob:
        config, blob = blob.get("config"), blob["state_dict"]
    model = DiffSepModel(config, device=device)
    model.score_model.load_state_dict(blob, strict=True)
    return model


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Separate all the wav files in a folder")
    parser.add_argument("input_dir", type=Path)
    parser.add_argument("output_dir", type=Path)
    parser.add_argument("--model", type=Path, required=True, help="port state dict (.pt)")
    parser.add_argument("-N", type=int, default=None, help="number of steps")
    parser.add_argument("--predictor", default="reverse_diffusion")
    parser.add_argument("--corrector", default="ald2")
    parser.add_argument("-s", "--schedule", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)

    model = load_model(args.model, args.device)
    fs_model = int(model.config["fs"])
    kw = dict(predictor_name=args.predictor, corrector_name=args.corrector)
    if args.N is not None:
        kw["N"] = args.N
    if args.schedule is not None:
        kw["schedule"] = args.schedule
    generator = torch.Generator(device=model.device).manual_seed(args.seed)

    for wavpath in sorted(args.input_dir.glob("*.wav")):
        mix, fs = load_wav(wavpath)
        if fs != fs_model:
            log.warning("skipping %s: %d Hz, the model expects %d Hz", wavpath.name, fs, fs_model)
            continue
        mix = mix[:1][None]  # (1, 1, T)
        # the raw mixture is projected onto estimates of the normalized
        # mixture: scale_output absorbs the std, and the mean is not added
        # back (separate() of a normalized mixture stays in that domain)
        (mix_n, _), _, _ = normalize_batch(torch.from_numpy(mix))
        est, _ = model.separate(mix_n, generator=generator, **kw)
        est = scale_output(mix, est.float().cpu().numpy())
        for src in range(est.shape[1]):
            save_wav(args.output_dir / f"s{src}" / f"{wavpath.stem}.wav", est[0, src], fs)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
