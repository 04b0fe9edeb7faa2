"""Long-form separation: fixed-size chunks, batched, permutation-aligned.

Counterpart of ``diffsep_tpu/streaming.py``. The mixture is cut into
overlapping chunks of one fixed length, which go through the PC sampler in
batches of that one shape; then the chunks are stitched:
  * each chunk's source order is aligned to its predecessor's by the
    correlation over their shared overlap (all n_src! orders scored), since
    diffusion separation may emit the speakers of two chunks swapped;
  * seams are crossfaded with a raised cosine over the overlap;
  * each chunk is normalized on its true length before it is padded, and
    denormalized after (``train.losses.normalize_rows_host``).
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from .train.losses import normalize_rows_host

__all__ = ["separate_streaming"]


def _best_perm(tail: np.ndarray, head: np.ndarray) -> tuple:
    """The order p of `head`'s sources best matching `tail` over the shared
    overlap: the largest sum of normalized correlations."""
    n_src = tail.shape[0]
    norm_t = np.linalg.norm(tail, axis=-1) + 1e-9
    norm_h = np.linalg.norm(head, axis=-1) + 1e-9
    corr = (tail @ head.T) / np.outer(norm_t, norm_h)
    best, best_score = tuple(range(n_src)), -np.inf
    for p in itertools.permutations(range(n_src)):
        s = sum(corr[i, p[i]] for i in range(n_src))
        if s > best_score:
            best, best_score = p, s
    return best


def separate_streaming(
    model,
    mix: np.ndarray,
    chunk_s: float = 5.0,
    overlap_s: float = 0.5,
    batch: int = 8,
    fs: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    **sampler_kwargs,
) -> np.ndarray:
    """Separate a (1, n) mixture of any length in chunks of ``chunk_s``
    seconds; returns (n_src, n). Every sampler run has the shape (batch, 1,
    chunk); its draws come from ``generator``, one batch after another."""
    if fs is None:
        fs = int(model.config["fs"])
    mix = np.asarray(mix, np.float32)
    if mix.ndim == 1:
        mix = mix[None, :]
    if mix.shape[0] != 1:
        raise ValueError(f"expected mono (1, n), got {mix.shape}")
    n = mix.shape[-1]
    chunk = max(int(round(chunk_s * fs)), 2)
    overlap = max(min(int(round(overlap_s * fs)), chunk // 2), 1)
    hop = chunk - overlap
    starts = [0] if n <= chunk else list(range(0, n - overlap, hop))
    rows, means, stds = normalize_rows_host([mix[:, s:s + chunk] for s in starts], chunk)

    predictor = sampler_kwargs.pop("predictor_name", "reverse_diffusion")
    corrector = sampler_kwargs.pop("corrector_name", "ald2")
    ests = []
    for off in range(0, len(rows), batch):
        group = rows[off:off + batch]
        real = len(group)
        group += [np.zeros_like(group[0])] * (batch - real)
        sampler = model.get_pc_sampler(predictor, corrector, torch.from_numpy(np.stack(group)),
                                       generator=generator, **sampler_kwargs)
        est = sampler()[0].float().cpu().numpy()
        ests += [est[j] * stds[off + j] + means[off + j] for j in range(real)]

    out = np.zeros((ests[0].shape[0], starts[-1] + chunk), np.float32)
    ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(overlap) / overlap)
    for ci, (s, est) in enumerate(zip(starts, ests)):
        if ci == 0:
            out[:, s:s + chunk] = est
            continue
        est = est[list(_best_perm(out[:, s:s + overlap], est[:, :overlap]))]
        out[:, s:s + overlap] = (1.0 - ramp) * out[:, s:s + overlap] + ramp * est[:, :overlap]
        out[:, s + overlap:s + chunk] = est[:, overlap:]
    return out[:, :n]
