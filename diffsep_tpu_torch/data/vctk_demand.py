"""VCTK-DEMAND (Valentini) noisy speech for enhancement.

Counterpart of ``diffsep_tpu/data/vctk_demand.py``. Enhancement is cast as
separation into 2 "sources", the target being [clean, noisy - clean]. The
train split crops a random ``audio_len`` seconds of each file, or tiles a
shorter file up to that length, and can permute the noise channels
(``augmentation``); the test split returns the whole pair. Items are numpy
(channels, samples) float32.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union

import numpy as np

from .audio_io import load_wav

split_map = {"test", "train"}


class NoisyDataset:
    """``<audio_path>/<split>/{noisy,clean}/<name>.wav``, the names those of
    the noisy folder."""

    def __init__(self, audio_path: Union[str, Path], audio_len: Union[int, float] = 4, fs: int = 16000,
                 augmentation: bool = False, split: str = "train", rng: Optional[np.random.Generator] = None):
        if split not in split_map:
            raise ValueError(f"The split parameter must be 'train' or 'test' (passed {split})")
        base = Path(audio_path) / split
        self.noisy_path = base / "noisy"
        self.clean_path = base / "clean"
        self.file_list = os.listdir(self.noisy_path)
        self.audio_len = int(audio_len * fs)
        self.fs = fs
        self.aug = augmentation
        self.split = split
        self.rng = rng or np.random.default_rng()

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, idx):
        noisy, _ = load_wav(self.noisy_path / self.file_list[idx])
        clean, _ = load_wav(self.clean_path / self.file_list[idx])
        if self.split == "test":
            return noisy, np.concatenate([clean, noisy - clean], axis=0)

        ori_len = noisy.shape[-1]
        if ori_len < self.audio_len:
            reps = -(-self.audio_len // ori_len)
            noisy = np.tile(noisy, (1, reps))[..., :self.audio_len]
            clean = np.tile(clean, (1, reps))[..., :self.audio_len]
        else:
            st = int(self.rng.integers(0, ori_len - self.audio_len + 1))
            noisy = noisy[..., st:st + self.audio_len]
            clean = clean[..., st:st + self.audio_len]
        if self.aug:
            # a permutation of the noise channels (one channel: the identity,
            # but it takes its draw from the generator)
            noise = noisy - clean
            noisy = noise[self.rng.permutation(clean.shape[0])] + clean
        return noisy, np.concatenate([clean, noisy - clean], axis=0)


def split_train_val(dataset: NoisyDataset, val_frac: float = 0.1, seed: int = 0):
    """The 90/10 train/val split of the train set: a permutation of the
    indices from ``seed``."""
    n = len(dataset)
    n_train = int(n * (1.0 - val_frac))
    perm = np.random.default_rng(seed).permutation(n)
    return Subset(dataset, perm[:n_train]), Subset(dataset, perm[n_train:])


class Subset:
    """The items of ``dataset`` at ``indices``."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = [int(i) for i in indices]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]
