"""Dual-path transformer network (DPTNet).

Counterpart of ``diffsep_tpu/models/dptnet.py``: ``ImprovedTransformerLayer``
(multi-head self-attention, then an RNN feed-forward, each with a residual
and a norm) and ``DPTNet``, which runs one layer along each chunk (intra,
always bidirectional) and one across chunks (inter) per block, then a PReLU
and a 1x1 conv. A library model, as in the JAX package: no recipe wires it.
The attention is plain matmuls and a softmax; the RNN is ``nn.LSTM``,
``nn.GRU`` or ``nn.RNN`` (tanh), batch first, bidirectional outputs
concatenated (forward, backward) as flax's ``nn.Bidirectional`` does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .model_utils import get_activation
from .tcn import PReLU, choose_norm

Tensor = torch.Tensor

__all__ = ["MultiHeadAttention", "ImprovedTransformerLayer", "DPTNet"]

_RNNS = {"RNN": nn.RNN, "LSTM": nn.LSTM, "GRU": nn.GRU}


class MultiHeadAttention(nn.Module):
    """Self-attention as flax's ``MultiHeadDotProductAttention`` with
    qkv_features = out_features = features: per-head queries scaled by
    1/sqrt(head_dim), softmax over the keys, dropout on the weights."""

    def __init__(self, features: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"features {features} is not a multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        self.query = nn.Linear(features, features)
        self.key = nn.Linear(features, features)
        self.value = nn.Linear(features, features)
        self.out = nn.Linear(features, features)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: Tensor) -> Tensor:
        b, s, f = x.shape
        h = self.num_heads

        def heads(proj):
            return proj(x).view(b, s, h, f // h).transpose(1, 2)

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        w = self.dropout(torch.softmax((q / math.sqrt(f // h)) @ k.transpose(-1, -2), dim=-1))
        return self.out((w @ v).transpose(1, 2).reshape(b, s, f))


class ImprovedTransformerLayer(nn.Module):
    """Attention + RNN feed-forward block on (batch, seq, input_size)."""

    def __init__(self, rnn_type: str, input_size: int, att_heads: int, hidden_size: int, dropout: float = 0.0,
                 activation: str = "relu", bidirectional: bool = True, norm: str = "gLN"):
        super().__init__()
        rnn_type = rnn_type.upper()
        if rnn_type not in _RNNS:
            raise ValueError(f"Only 'RNN', 'LSTM' and 'GRU' are supported, got {rnn_type}")
        self.self_attn = MultiHeadAttention(input_size, att_heads, dropout)
        self.norm1 = choose_norm(norm, input_size)
        self.rnn = _RNNS[rnn_type](input_size, hidden_size, batch_first=True, bidirectional=bidirectional)
        self.feed_forward = nn.Linear(hidden_size * (2 if bidirectional else 1), input_size)
        self.norm2 = choose_norm(norm, input_size)
        self.dropout = nn.Dropout(dropout)
        self.activation = get_activation(activation)

    @staticmethod
    def _norm(norm: nn.Module, x: Tensor) -> Tensor:
        return norm(x.transpose(1, 2)).transpose(1, 2)

    def forward(self, x: Tensor) -> Tensor:
        out = self._norm(self.norm1, self.dropout(self.self_attn(x)) + x)
        rnn_out = self.rnn(out)[0]
        ff = self.feed_forward(self.dropout(self.activation(rnn_out)))
        return self._norm(self.norm2, self.dropout(ff) + out)


class DPTNet(nn.Module):
    """Dual-path transformer: forward(x (batch, N, chunk_size, n_chunks)) ->
    (batch, output_size, chunk_size, n_chunks), N = input_size."""

    def __init__(self, rnn_type: str, input_size: int, hidden_size: int, output_size: int, att_heads: int = 4,
                 dropout: float = 0.0, activation: str = "relu", num_layers: int = 1, bidirectional: bool = True,
                 norm_type: str = "gLN"):
        super().__init__()

        def layer(bi):
            return ImprovedTransformerLayer(rnn_type, input_size, att_heads, hidden_size, dropout, activation,
                                            bi, norm_type)

        self.row_transformer = nn.ModuleList(layer(True) for _ in range(num_layers))
        self.col_transformer = nn.ModuleList(layer(bidirectional) for _ in range(num_layers))
        self.output_prelu = PReLU()
        self.output_conv = nn.Conv2d(input_size, output_size, 1)

    def forward(self, x: Tensor) -> Tensor:
        b, n, chunk, n_chunks = x.shape
        for row, col in zip(self.row_transformer, self.col_transformer):
            # intra-chunk: the sequence axis is chunk_size
            h = row(x.permute(0, 3, 2, 1).reshape(b * n_chunks, chunk, n))
            x = h.reshape(b, n_chunks, chunk, n).permute(0, 3, 2, 1)
            # inter-chunk: the sequence axis is n_chunks
            h = col(x.permute(0, 2, 3, 1).reshape(b * chunk, n_chunks, n))
            x = h.reshape(b, chunk, n_chunks, n).permute(0, 3, 1, 2)
        return self.output_conv(self.output_prelu(x))
