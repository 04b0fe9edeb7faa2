"""Time-domain score model around the DiffuSE backbone.

Counterpart of ``diffsep_tpu/models/score_model_diffuse.py``: the same
(x_t, t, mix) -> score interface as ``ScoreModelNCSNpp``, on waveforms (no
STFT frontend); the mixture is the backbone's conditioner and t goes to its
step embedding as it is.
"""
from __future__ import annotations

import torch
from torch import nn

Tensor = torch.Tensor


class ScoreModelDiffuSE(nn.Module):
    """Callable as (x_t (batch, num_sources, samples), time_cond (batch,),
    mix (batch, 1, samples)) -> score (batch, num_sources, samples)."""

    def __init__(self, backbone: nn.Module, num_sources: int = 2):
        super().__init__()
        self.backbone = backbone
        self.num_sources = num_sources

    def forward(self, xt: Tensor, time_cond: Tensor, mix: Tensor) -> Tensor:
        return self.backbone(xt, time_cond, mix)
