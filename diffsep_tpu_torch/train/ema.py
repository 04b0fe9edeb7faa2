"""Exponential moving average of the parameters.

Counterpart of ``diffsep_tpu/train/ema.py``: the shadow is updated after
every applied optimizer step with decay_t = min(decay, (1 + n) / (10 + n)),
n the number of updates so far including this one. ``swapped`` puts the
shadow into the model for evaluation and the trained weights back after.
The shadow is updated in place.
"""
from __future__ import annotations

import contextlib
from typing import List, Sequence

import torch

Tensor = torch.Tensor


class EMA:
    def __init__(self, params: Sequence[Tensor]):
        self.params: List[Tensor] = [p.detach().clone() for p in params]
        self.num_updates = 0

    @torch.no_grad()
    def update(self, params: Sequence[Tensor], decay: float = 0.999) -> None:
        self.num_updates += 1
        n = self.num_updates
        one_minus = 1.0 - min(decay, (1.0 + n) / (10.0 + n))
        # s - (1 - decay_t) (s - p), as the JAX package writes it
        diff = torch._foreach_sub(self.params, [p.detach() for p in params])
        torch._foreach_mul_(diff, one_minus)
        torch._foreach_sub_(self.params, diff)

    def state_dict(self, names: Sequence[str]) -> dict:
        return {"params": dict(zip(names, self.params)), "num_updates": self.num_updates}

    def load_state_dict(self, state: dict, names: Sequence[str]) -> None:
        with torch.no_grad():
            for s, name in zip(self.params, names):
                s.copy_(state["params"][name])
        self.num_updates = int(state["num_updates"])


@contextlib.contextmanager
def swapped(ema: EMA, params: Sequence[Tensor]):
    """The EMA weights in ``params`` inside the block, the trained ones
    after it."""
    with torch.no_grad():
        saved = [p.detach().clone() for p in params]
        for p, s in zip(params, ema.params):
            p.copy_(s)
    try:
        yield
    finally:
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
