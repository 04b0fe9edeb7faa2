"""A seeded synthetic WSJ0-mix folder, for runs where the corpus is absent.

``write_wsj0_mix`` writes the layout ``WSJ0_mix`` reads,
``2speakers/wav8k/max/{tr,cv}/{mix,s1,s2}/<name>.wav``: each source a sum
of tone bursts (random pitch, onset and length under a Hann envelope),
the mixture their sum, 16-bit PCM. It stands in for the real data in the
smoke run and the tests; it is no benchmark of separation quality.
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
