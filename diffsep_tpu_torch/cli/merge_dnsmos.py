"""Merge DNSMOS scores, computed elsewhere, into the result JSONs.

    python -m diffsep_tpu_torch.cli.merge_dnsmos RESULT_DIR [--overwrite-results]

Counterpart of ``diffsep_tpu/cli/merge_dnsmos.py`` (the reference's
``merge_dnsmos.py``). For each split of val, test, libri-clean and
libri-noisy that has both ``{split}.json`` (``cli.evaluate``'s records) and
``{split}_dnsmos.csv`` (the DNSMOS tool's output: its header is checked, and
each row names a ``NNNN.enhC.wav``) in RESULT_DIR, every record gets its
channels' DNSMOS values, and the split is summarized again into
``{split}_with_dnsmos.json`` and ``{split}_summary_with_dnsmos.json`` (or
over ``{split}.json`` and ``{split}_summary.json`` with
``--overwrite-results``). Both record layouts are read: the list that
``cli.evaluate`` writes and the sample-keyed dict of ``cli.evaluate_mp``.
Nothing is downloaded: DNSMOS runs outside this package.
"""
from __future__ import annotations

import argparse
import csv
import json
import logging
from collections import defaultdict
from pathlib import Path

from .eval_common import summarize_mp

log = logging.getLogger(__name__)

FIELDNAMES = [
    "",
    "filename",
    "len_in_sec",
    "sr",
    "num_hops",
    "OVRL_raw",
    "SIG_raw",
    "BAK_raw",
    "OVRL",
    "SIG",
    "BAK",
]
TYPES = {
    "filename": Path,
    "len_in_sec": float,
    "sr": int,
    "num_hops": int,
    "OVRL_raw": float,
    "SIG_raw": float,
    "BAK_raw": float,
    "OVRL": float,
    "SIG": float,
    "BAK": float,
}


def parse_dnsmos_csv(filepath: Path):
    """CSV -> {sample_idx: {metric: [per-channel values]}}, the header
    checked against the DNSMOS tool's."""
    dnsmos = defaultdict(dict)
    with open(filepath, newline="") as csvfile:
        for idx, row in enumerate(csv.reader(csvfile, delimiter=",")):
            if idx == 0:
                for f1, f2 in zip(row, FIELDNAMES):
                    if f1 != f2:
                        raise ValueError(
                            f"There might be an error in the DNSMOS file "
                            f"({f1} != {f2})"
                        )
                continue
            sample, channel = Path(row[1]).stem.split(".")
            sample_idx = int(sample)
            channel_idx = int(channel[3:])
            dnsmos[sample_idx][channel_idx] = {
                key: TYPES[key](val) for key, val in zip(FIELDNAMES[2:], row[2:])
            }
    if not dnsmos:
        raise ValueError("Empty DNSMOS file")

    num_chan = max(len(v) for v in dnsmos.values())
    errors = {k: len(v) for k, v in dnsmos.items() if len(v) != num_chan}
    for sample_idx, n in errors.items():
        log.warning("sample %d has only %d channels", sample_idx, n)

    out = {}
    for sample_idx, chans in dnsmos.items():
        out[sample_idx] = {
            key: [chans[c][key] for c in sorted(chans)] for key in FIELDNAMES[2:]
        }
    return out


def merge_split(results_path: Path, dnsmos_path: Path, overwrite: bool):
    dnsmos = parse_dnsmos_csv(dnsmos_path)
    with open(results_path) as f:
        results = json.load(f)

    if isinstance(results, list):
        # cli.evaluate writes a list of records, cli.evaluate_mp (and the
        # reference's merge) a sample-keyed dict: the summary takes the dict
        for pos, entry in enumerate(results):
            # a record without batch_idx takes its position
            idx = int(entry.get("batch_idx", pos))
            if idx not in dnsmos:
                raise ValueError(f"Sample {idx} not found in DNSMOS file")
            entry.update(dnsmos[idx])
        # keyed by position: keyed by batch_idx, records with the same index
        # would collapse into one and leave the summary's count short
        as_dict = dict(enumerate(results))
    else:
        for idx, metrics in results.items():
            if int(idx) not in dnsmos:
                raise ValueError(f"Sample {idx} not found in DNSMOS file")
            metrics.update(dnsmos[int(idx)])
        as_dict = results

    # the reference's summary: evaluate_mp's with ignore_inf=False, which
    # leaves an infinite value out of its metric's mean (summarize_mp)
    summary = summarize_mp(as_dict, ignore_inf=False)
    split = results_path.stem
    base = results_path.parent
    if overwrite:
        out_results = results_path
        out_summary = base / f"{split}_summary.json"
    else:
        out_results = base / f"{split}_with_dnsmos.json"
        out_summary = base / f"{split}_summary_with_dnsmos.json"
    with open(out_results, "w") as f:
        json.dump(results, f, indent=2)
    with open(out_summary, "w") as f:
        json.dump(summary, f, indent=2)
    log.info("%s: %s", split, summary)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(
        description="Merge DNSMOS evaluation results into main result file"
    )
    parser.add_argument("results_path", type=Path, help="Path to result folder")
    parser.add_argument("--overwrite-results", action="store_true")
    args = parser.parse_args(argv)

    for split in ["val", "test", "libri-clean", "libri-noisy"]:
        results_path = args.results_path / f"{split}.json"
        dnsmos_path = args.results_path / f"{split}_dnsmos.csv"
        if not results_path.exists():
            log.info("Seems evaluate has not been run for %s. Skip.", split)
            continue
        if not dnsmos_path.exists():
            log.info("Seems DNSMOS evaluation has not been run for %s. Skip.", split)
            continue
        merge_split(results_path, dnsmos_path, args.overwrite_results)


if __name__ == "__main__":
    main()
