"""Gradient clipping: fixed max-norm and AutoClip (percentile of history).

Counterpart of ``diffsep_tpu/train/clippers.py``. A clipper is called as
``clip(grads, state) -> (state, (grad_norm, threshold))`` and scales the
list of gradients in place by min(1, threshold / grad_norm). Norms and
thresholds are float32 tensors on the gradients' device, so a step never
waits for the card. AutoClip keeps its history in a fixed ring buffer:
the percentile is exact once the buffer is warm and over the filled prefix
before that.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def grad_norm(grads: Sequence[Tensor]) -> Tensor:
    """Global L2 norm over a list of gradients, in float32."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([g.float() for g in grads])))


def _scale_(grads: List[Tensor], norm: Tensor, max_norm: Tensor) -> None:
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    torch._foreach_mul_(grads, scale)


class FixedClipper:
    """Clip to a fixed global norm."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def init(self, device=None):
        return None

    def __call__(self, grads: List[Tensor], state=None) -> Tuple[None, Tuple[Tensor, Tensor]]:
        norm = grad_norm(grads)
        # a fill on the card, not a copy from host memory (which would wait
        # for the card)
        max_norm = torch.full((), self.max_norm, dtype=torch.float32, device=norm.device)
        _scale_(grads, norm, max_norm)
        return state, (norm, max_norm)


@dataclass
class AutoClipState:
    history: Tensor  # (capacity,) float32 ring buffer
    count: int  # norms recorded so far


class AutoClipper:
    """Clip to the p-th percentile of the gradient norms seen so far."""

    def __init__(self, p: float, capacity: int = 10000):
        self.p = p
        self.capacity = capacity

    def init(self, device=None) -> AutoClipState:
        return AutoClipState(torch.zeros((self.capacity,), dtype=torch.float32, device=device), 0)

    def __call__(self, grads: List[Tensor], state: AutoClipState):
        norm = grad_norm(grads)
        state.history[state.count % self.capacity] = norm
        state.count += 1
        n_valid = min(state.count, self.capacity)
        # floor(p / 100 * n) in float32, as the JAX package computes it
        index = min(int(np.float32(self.p / 100.0) * np.float32(n_valid)), n_valid - 1)
        thresh = torch.sort(state.history[:n_valid]).values[index]
        _scale_(grads, norm, thresh)
        return state, (norm, thresh)


def make_clipper(kind: str, max_norm: float = 5.0, percentile: float = 10.0) -> Optional[object]:
    if kind == "fixed":
        return FixedClipper(max_norm)
    if kind == "autoclip":
        return AutoClipper(percentile)
    if kind == "none":
        return None
    raise ValueError(kind)
