"""Solving a positive semi-definite system robustly.

Counterpart of ``diffsep_tpu/utils/linalg.py``: ``solve_psd_loaded`` loads
the diagonal in proportion to its mean magnitude and solves the Jacobi
(diagonally) preconditioned system.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def solve_psd_loaded(A: Tensor, b: Tensor, load: float = 1e-5) -> Tensor:
    """Solve (A + load * mean(diag A) * I) x = b for a PSD A (..., n, n);
    b is (..., n) or (..., n, k). ``load`` is relative to the mean diagonal
    magnitude."""
    n = A.shape[-1]
    diag_mean = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / n
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    loaded = A + (load * diag_mean)[..., None, None] * eye
    d = torch.sqrt(torch.clamp(torch.diagonal(loaded, dim1=-2, dim2=-1), min=1e-30))
    P = loaded / d[..., :, None] / d[..., None, :]
    squeeze = b.ndim == A.ndim - 1
    if squeeze:
        b = b[..., None]
    y = torch.linalg.solve(P, b / d[..., :, None])
    x = y / d[..., :, None]
    return x[..., 0] if squeeze else x
