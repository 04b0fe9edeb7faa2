"""Parameter counts and moving nested tensors between devices.

Counterpart of ``diffsep_tpu/utils/params.py``: ``count_parameters`` of a
module or of a tree (dicts, lists, tuples) of tensors, ``to_device`` of
such a tree.
"""
from __future__ import annotations

from typing import Any, Iterator

import torch
from torch import nn


def _leaves(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def count_parameters(params, trainable_only: bool = True) -> int:
    """Scalar parameters of a module (those that take gradients, unless
    ``trainable_only`` is False) or of a tree of tensors (every leaf)."""
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters() if p.requires_grad or not trainable_only)
    return sum(t.numel() for t in _leaves(params))


def to_device(tree: Any, device) -> Any:
    """The tree with every tensor on ``device``; other leaves as they are."""
    device = torch.device(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return type(tree)((k, to_device(v, device)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(to_device(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree
