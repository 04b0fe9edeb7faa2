"""CSIG/CBAK/COVL of enhanced wavs against their clean targets.

    python -m diffsep_tpu_torch.cli.evaluate_covl CLEAN_DIR ENHANCED_DIR [--sr 16000]
    python -m diffsep_tpu_torch.cli.evaluate_covl RESULTS/wav/test RESULTS/wav/test

Counterpart of ``diffsep_tpu/cli/evaluate_covl.py`` (the reference's
``evaluate_covl.py``). Every target wav under CLEAN_DIR is paired with its
estimate in ENHANCED_DIR, in either naming:
  * the reference's, ``NNNN.tgtC.wav`` beside ``NNNN.enhC.wav`` in another
    folder;
  * the one ``cli.evaluate --save-n`` writes (``cli/eval_common.py:
    save_samples``), ``NNN_tgtC.wav`` and ``NNN_enhC.wav`` in one folder
    (``<result dir>/wav/<split>``), so the two paths may be the same; the
    mixtures there are no targets and are skipped.
The Hu & Loizou composites (``models/composite.py``, PESQ from
``models/pesq_native.py``) run in a host pool, and
``{split}_covl.json`` (sample -> metric -> per-channel values) and
``{split}_summary_covl.json`` are written two levels above ENHANCED_DIR,
``split`` being its name: beside ``{split}.json`` of ``cli.evaluate``. A pair
whose estimate is missing is logged and left out of the summary.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import re
from pathlib import Path
from typing import Optional, Tuple

from ..data.audio_io import load_wav
from ..models.composite import eval_composite
from ..utils.processing_pool import ProcessingPool
from .eval_common import summarize_mp

log = logging.getLogger(__name__)

_TARGET = re.compile(r"^(\d+)([._])tgt(\d+)$")


def filename_tgt2enh(tgt_path: Path, enhanced_path: Path) -> Optional[Tuple[int, int, Path]]:
    """``NNNN.tgtC.wav`` (or ``NNN_tgtC.wav``) -> (NNNN, C, the estimate's
    path in ``enhanced_path``); None for a file that is no target."""
    m = _TARGET.match(tgt_path.stem)
    if m is None:
        return None
    return int(m.group(1)), int(m.group(3)), enhanced_path / f"{m.group(1)}{m.group(2)}enh{m.group(3)}.wav"


def compute_one(sample_idx: int, channel_idx: int, clean_f: Path, enh_f: Path, sr: int):
    clean, _ = load_wav(clean_f)
    enh, _ = load_wav(enh_f)
    return sample_idx, channel_idx, eval_composite(clean[0], enh[0], fs=sr)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description="Compute COVL, CSIG, and CBAK metrics from Hu and Loizou")
    parser.add_argument("clean_path", type=Path, help="Path to folder of clean files")
    parser.add_argument("enhanced_path", type=Path, help="Path to folder of enhanced files")
    parser.add_argument("--sr", type=int, default=16000)
    args = parser.parse_args(argv)

    split = args.enhanced_path.name
    output_path = args.enhanced_path.parents[1]
    pairs = []
    for clean_f in sorted(args.clean_path.rglob("*.wav")):
        pair = filename_tgt2enh(clean_f, args.enhanced_path)
        if pair is not None:
            pairs.append((*pair, clean_f))
    with ProcessingPool(os.cpu_count()) as pool:
        for sample_idx, channel_idx, enh_f, clean_f in pairs:
            pool.push(compute_one, sample_idx, channel_idx, clean_f, enh_f, args.sr)
        results = pool.wait_results(progress_bar=True)

    n_ok = sum(1 for r in results if r)
    if n_ok < len(pairs):
        # a missing or unreadable estimate gives None: say so, so that the
        # summary is not taken for the whole set
        log.warning("%d/%d pairs failed (missing or unreadable estimates); the summary covers the other %d",
                    len(pairs) - n_ok, len(pairs), n_ok)

    output = {}
    for sample_idx, _, res in sorted((r for r in results if r), key=lambda x: tuple(x[:2])):
        entry = output.setdefault(sample_idx, {})
        for met in ("csig", "cbak", "covl"):
            entry.setdefault(met, []).append(res[met])

    # the reference's summary: evaluate_mp's over the sample-keyed dict
    summary = summarize_mp(output)
    log.info("%s", summary)
    with open(output_path / f"{split}_covl.json", "w") as f:
        json.dump(output, f, indent=2)
    with open(output_path / f"{split}_summary_covl.json", "w") as f:
        json.dump(summary, f, indent=2)


if __name__ == "__main__":
    main()
