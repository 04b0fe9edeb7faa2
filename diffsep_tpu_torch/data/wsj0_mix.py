"""WSJ0-mix / LibriMix dataset reader and the pad-to-longest collator.

Counterpart of ``diffsep_tpu/data/wsj0_mix.py``: the directory layout
``{n}speakers/wav{8,16}k/{min,max}/{tr,cv,tt}`` with ``mix/`` (or a
LibriMix ``mix_clean``/``mix_both``) and ``s1..sN/``, random crops to
``max_len_s`` drawn from ``rng``, ``max_n_samples`` truncation, and the
centered pad-to-longest collator. Items are numpy arrays; the training loop
moves batches to the card.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union

import numpy as np

from .audio_io import load_wav

split_map = {"test": "tt", "val": "cv", "train": "tr", "libri2mix_test": "test"}


class WSJ0_mix:
    def __init__(self, path: Union[str, Path], n_spkr: int = 2, fs: int = 16000, cut: str = "max",
                 split: str = "train", max_len_s: Optional[float] = None,
                 max_n_samples: Optional[int] = None, mix_dir: str = "mix",
                 rng: Optional[np.random.Generator] = None):
        self.base_folder = Path(path)
        self.n_spkr = n_spkr
        self.fs = int(fs)
        self.cut = cut
        self.max_len = int(self.fs * max_len_s) if max_len_s is not None else None
        self.rng = rng or np.random.default_rng()
        if fs not in (8000, 16000):
            raise ValueError(f"The sampling frequency fs can be only 8000 or 16000 (passed {fs})")
        if n_spkr not in (2, 3):
            raise ValueError(f"The number of speakers can only be 2 or 3 (passed {n_spkr})")
        if cut not in ("min", "max"):
            raise ValueError(f"The cut parameter has to be 'min' or 'max' (passed {cut})")
        if split not in split_map:
            raise ValueError(f"The split parameter must be 'train', 'val', or 'test' (passed {split})")
        self.path = self.base_folder / f"{self.n_spkr}speakers/wav{self.fs // 1000}k/{cut}/{split_map[split]}"
        self.path_mix = self.path / mix_dir
        self.path_src = [self.path / f"s{i + 1}" for i in range(self.n_spkr)]
        self.file_list = sorted(os.listdir(self.path_mix))
        if max_n_samples is not None:
            self.file_list = self.file_list[:max_n_samples]

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, idx):
        filename = self.file_list[idx]
        mix, _ = load_wav(self.path_mix / filename)
        tgt = np.concatenate([load_wav(p / filename)[0] for p in self.path_src], axis=0)
        if self.max_len is not None and tgt.shape[-1] > self.max_len:
            p = int(self.rng.integers(0, tgt.shape[-1] - self.max_len))
            tgt = tgt[..., p : p + self.max_len]
            mix = mix[..., p : p + self.max_len]
        return mix, tgt


def max_collator(batch, pad_to_multiple: Optional[int] = None):
    """Pad every signal to the longest in the batch, centered; with
    ``pad_to_multiple`` the padded length is rounded up to a multiple of it,
    so batch shapes fall into a few sizes."""
    max_len = max(row[0].shape[-1] for row in batch)
    if pad_to_multiple:
        max_len = -(-max_len // pad_to_multiple) * pad_to_multiple
    stacked = []
    for f in range(len(batch[0])):
        out = []
        for row in batch:
            el = row[f]
            off = max_len - el.shape[-1]
            out.append(np.pad(el, [(0, 0)] * (el.ndim - 1) + [(off // 2, off - off // 2)]))
        stacked.append(np.stack(out, axis=0))
    return tuple(stacked)
