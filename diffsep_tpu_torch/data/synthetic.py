"""Seeded synthetic corpora, for runs where the real ones are absent.

``write_wsj0_mix`` writes the layout ``WSJ0_mix`` reads,
``2speakers/wav8k/max/{tr,cv}/{mix,s1,s2}/<name>.wav``: each source a sum
of tone bursts (random pitch, onset and length under a Hann envelope),
the mixture their sum, 16-bit PCM. ``write_vctk_demand`` writes the layout
``NoisyDataset`` reads, ``{train,test}/{clean,noisy}/<name>.wav``: the
clean "speech" tone bursts of 1-4 s, the noisy file that plus seeded noise
at one of a few SNRs. They stand in for the real data in the smoke run and
the tests; they are no benchmark of separation or enhancement quality.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from .audio_io import save_wav

SPLITS = {"train": "tr", "val": "cv", "test": "tt"}


def tone_bursts(rng: np.random.Generator, n: int, fs: int, bursts: int = 6) -> np.ndarray:
    t = np.arange(n) / fs
    out = np.zeros(n)
    for _ in range(bursts):
        start = int(rng.integers(0, max(1, n - fs // 4)))
        length = int(rng.integers(fs // 8, fs))
        seg = slice(start, min(n, start + length))
        f0 = rng.uniform(100.0, 0.4 * fs)
        env = np.hanning(seg.stop - seg.start)
        out[seg] += rng.uniform(0.05, 0.3) * env * np.sin(2 * np.pi * f0 * t[seg] + rng.uniform(0, 2 * np.pi))
    return out.astype(np.float32)


def write_wsj0_mix(root, counts: Dict[str, int], seconds: float = 5.0, fs: int = 8000, n_spkr: int = 2,
                   seed: int = 0) -> Path:
    """Write ``counts[split]`` mixtures of ``seconds`` per split under
    ``root``; returns ``root``."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    n = int(round(seconds * fs))
    for split, count in counts.items():
        base = root / f"{n_spkr}speakers/wav{fs // 1000}k/max/{SPLITS[split]}"
        for i in range(count):
            srcs = [tone_bursts(rng, n, fs) for _ in range(n_spkr)]
            name = f"{split}{i:04d}.wav"
            for k, s in enumerate(srcs):
                save_wav(base / f"s{k + 1}" / name, s[None], fs)
            save_wav(base / "mix" / name, np.sum(srcs, axis=0)[None], fs)
    return root


SNRS_DB = (0.0, 5.0, 10.0, 15.0)


def write_vctk_demand(root, n_train: int, n_test: int, fs: int = 16000, seed: int = 0,
                      seconds=(1.0, 4.0)) -> Path:
    """Write ``n_train`` and ``n_test`` clean/noisy pairs of a uniform
    length in ``seconds`` (some shorter than the recipe's 3 s crop, which
    tiles them) under ``root``; returns ``root``. The noise is white or
    low-passed white at an SNR of ``SNRS_DB``, and each pair is scaled to a
    peak of 0.9 so that the 16-bit files do not clip."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    for split, count in (("train", n_train), ("test", n_test)):
        for i in range(count):
            n = int(rng.integers(int(seconds[0] * fs), int(seconds[1] * fs) + 1))
            clean = tone_bursts(rng, n, fs, bursts=max(2, n * 3 // fs)).astype(np.float64)
            noise = rng.standard_normal(n)
            if rng.uniform() < 0.5:  # low-passed: a 9-tap moving average
                noise = np.convolve(noise, np.ones(9) / 9, mode="same")
            snr = SNRS_DB[int(rng.integers(len(SNRS_DB)))]
            p_clean = max(float(np.mean(clean**2)), 1e-8)
            noise *= np.sqrt(p_clean / (np.mean(noise**2) * 10 ** (snr / 10)))
            noisy = clean + noise
            g = 0.9 / max(np.abs(noisy).max(), np.abs(clean).max())
            name = f"p{i:03d}_{split}.wav"
            save_wav(root / split / "clean" / name, (g * clean)[None].astype(np.float32), fs)
            save_wav(root / split / "noisy" / name, (g * noisy)[None].astype(np.float32), fs)
    return root
