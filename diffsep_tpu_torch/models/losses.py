"""Validation metrics: SI-SDR, its permutation-invariant form, the SI-SDR
loss used as ``val/si_sdr``, and PESQ, the enhancement recipe's
``val/pesq``.

Counterpart of ``si_sdr``, ``si_sdr_pit``, ``SISDRLoss`` and ``PESQ`` in
``diffsep_tpu/models/losses.py``: every permutation of the sources is
scored (exact for the 2 or 3 sources of the datasets); PESQ runs on the
host, in numpy (``pesq_native.py``).
"""
from __future__ import annotations

import itertools
import logging
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor

__all__ = ["si_sdr", "si_sdr_pit", "SISDRLoss", "PESQ"]

log = logging.getLogger(__name__)

_EPS = 1e-8


def _pairwise_si_sdr(est: Tensor, ref: Tensor, zero_mean: bool, clamp_db: Optional[float]) -> Tensor:
    """si_sdr[..., i, j] of est source j against ref source i; est, ref
    (..., n_src, time)."""
    if zero_mean:
        est = est - est.mean(dim=-1, keepdim=True)
        ref = ref - ref.mean(dim=-1, keepdim=True)
    dot = torch.einsum("...it,...jt->...ij", ref, est)
    ref_pow = (ref ** 2).sum(dim=-1)[..., :, None]
    scale = dot / torch.clamp(ref_pow, min=_EPS)
    # ||scale ref_i||^2 and ||est_j - scale ref_i||^2 without the (i, j, t) tensor
    target_pow = scale ** 2 * ref_pow
    est_pow = (est ** 2).sum(dim=-1)[..., None, :]
    err_pow = est_pow - 2 * scale * dot + target_pow
    ratio = target_pow / torch.clamp(err_pow, min=_EPS)
    sdr = 10.0 * torch.log10(torch.clamp(ratio, min=1e-30))
    if clamp_db is not None:
        sdr = torch.clamp(sdr, -clamp_db, clamp_db)
    return sdr


def si_sdr(est: Tensor, ref: Tensor, zero_mean: bool = False, clamp_db: Optional[float] = None) -> Tensor:
    """Per-source SI-SDR without permutation search: (..., n_src)."""
    return torch.diagonal(_pairwise_si_sdr(est, ref, zero_mean, clamp_db), dim1=-2, dim2=-1)


def si_sdr_pit(est: Tensor, ref: Tensor, zero_mean: bool = False, clamp_db: Optional[float] = None,
               return_perm: bool = False):
    """SI-SDR under the source alignment of best mean: (..., n_src), and
    optionally the permutation (ref index -> est index)."""
    m = _pairwise_si_sdr(est, ref, zero_mean, clamp_db)
    n = m.shape[-1]
    perms = torch.tensor(list(itertools.permutations(range(n))), device=m.device)
    rows = torch.arange(n, device=m.device)
    scores = torch.stack([m[..., rows, p].sum(dim=-1) for p in perms], dim=-1)
    best_perm = perms[torch.argmax(scores, dim=-1)]
    vals = torch.take_along_dim(m, best_perm[..., :, None], dim=-1)[..., 0]
    return (vals, best_perm) if return_perm else vals


class SISDRLoss:
    """Negative PIT SI-SDR; ``sign_flip`` gives the SI-SDR itself (the
    validation metric)."""

    def __init__(self, zero_mean: bool = False, clamp_db: Optional[float] = None,
                 reduction: str = "mean", sign_flip: bool = False):
        if reduction not in ("mean", "sum", "none"):
            raise ValueError("reduction must be one of 'none'|'mean'|'sum'")
        self.zero_mean = zero_mean
        self.clamp_db = clamp_db
        self.reduction = reduction
        self.sign_flip = sign_flip

    def __call__(self, est: Tensor, ref: Tensor) -> Tensor:
        neg = -si_sdr_pit(est, ref, self.zero_mean, self.clamp_db).mean(dim=-1)
        if self.sign_flip:
            neg = -neg
        if self.reduction == "mean":
            return neg.mean()
        if self.reduction == "sum":
            return neg.sum()
        return neg


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)


class PESQ:
    """PESQ of the first channel (the clean speech of the enhancement
    target) of the first ``max_items`` batch entries, averaged over the
    items that score: one short or silent clip does not discard the batch,
    the items dropped are logged, and a batch where none scores raises."""

    def __init__(self, mode: str = "wb", fs: int = 16000, max_items: int = 4):
        self.mode = mode
        self.fs = fs
        self.max_items = max_items

    def __call__(self, est, ref) -> float:
        from .pesq_native import get_pesq

        _pesq = get_pesq()
        est, ref = _host(est), _host(ref)
        if est.ndim != 3 or ref.ndim != 3:
            raise ValueError(
                f"PESQ expects (batch, channels, samples) arrays, got est{est.shape} / ref{ref.shape}")
        n = min(self.max_items, est.shape[0])
        vals, last_err = [], None
        for i in range(n):
            try:
                vals.append(_pesq(self.fs, ref[i, 0], est[i, 0], self.mode))
            except Exception as e:  # noqa: BLE001 - scored per item, as in the JAX package
                last_err = e
        if not vals:
            raise last_err if last_err is not None else ValueError("empty batch")
        if len(vals) < n:
            log.warning("PESQ dropped %d/%d items (last error: %s); metric is the mean of the surviving %d",
                        n - len(vals), n, last_err, len(vals))
        return float(np.mean(vals))
