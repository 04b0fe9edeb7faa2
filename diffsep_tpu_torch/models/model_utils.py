"""Small model helpers.

Counterpart of ``diffsep_tpu/models/model_utils.py``: the activation table
of the reference's ``models/utils.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_ACTIVATIONS = {
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "tanh": torch.tanh,
    "relu": F.relu,
    "selu": F.selu,
    "swish": F.silu,
}


def get_activation(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"Unknown activation '{name}'") from None
