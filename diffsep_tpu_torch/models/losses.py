"""Separation metrics: SI-SDR, its permutation-invariant form, and the
SI-SDR loss used as the validation metric ``val/si_sdr``.

Counterpart of ``si_sdr``, ``si_sdr_pit`` and ``SISDRLoss`` in
``diffsep_tpu/models/losses.py``: every permutation of the sources is
scored (exact for the 2 or 3 sources of the datasets). PESQ comes with the
enhancement recipe.
"""
from __future__ import annotations

import itertools
from typing import Optional

import torch

Tensor = torch.Tensor

__all__ = ["si_sdr", "si_sdr_pit", "SISDRLoss"]

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
