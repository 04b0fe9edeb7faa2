"""Tensor-parallel separation over a 2-D (dp, tp) layout of the process
group: one utterance served by several cards.

Counterpart of ``diffsep_tpu/parallel/tensor_parallel.py``. The JAX package
annotates the parameters' shardings and lets GSPMD place the collectives;
the port places them by hand:

  * which weights split (``tp_shardings``), the JAX package's rule: each
    conv and dense weight on its output-channel axis where the tp degree
    divides it, its bias (a rank-1 channel vector) with it; everything else
    replicated. GroupNorm's scale and shift stay whole: their layer reads
    every channel of a group;
  * each rank of a tp group computes its slice of a split layer's output
    channels with its slice of the weight (the 3x3 convs on the hand kernel
    at Cout / tp), and the group all-gathers the slices on the channel axis
    right after the layer (``shard_tp``), so every layer that contracts over
    channels (the next conv, GroupNorm, attention, the FIR resamplers) reads
    whole activations. One all-gather per split layer: simple and correct,
    not the fewest bytes;
  * the dp ranks take different rows of the batch; every rank of one tp
    group draws the same noise, so that they sample the same utterance.

A rank holds 1/tp of each split weight. Without a process group (one
process) dp = tp = 1 and nothing is split.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..models import layers
from . import mesh
from .shard_eval import _NOISE_BATCH_AXIS, _slice_noise, pad_batch_to_devices

__all__ = ["TpMesh", "make_mesh_2d", "make_tp_separate", "shard_tp", "tp_shardings"]


@dataclasses.dataclass
class TpMesh:
    """This rank's place in a (dp, tp) layout of the process group: rank r
    is at (r // tp, r % tp), so a tp group holds adjacent ranks (on one
    host, its cards' fastest links). ``tp_group`` joins the ranks of this
    rank's row, ``dp_group`` those of its column (None where that size is
    1)."""

    dp: int
    tp: int
    dp_index: int
    tp_index: int
    tp_group: Optional[object]
    dp_group: Optional[object]


def make_mesh_2d(dp: int, tp: int) -> TpMesh:
    """The (dp, tp) layout over every rank of the process group (world size
    dp * tp; 1 x 1 without a group). Every rank calls it."""
    world, rank = mesh.world_size(), mesh.rank()
    if dp * tp != world:
        raise ValueError(f"a {dp} x {tp} layout needs {dp * tp} ranks, the process group has {world}")
    tp_group = dp_group = None
    if tp > 1:
        # every rank creates every group, in the same order
        groups = [dist.new_group([d * tp + j for j in range(tp)]) for d in range(dp)]
        tp_group = groups[rank // tp]
    if dp > 1:
        groups = [dist.new_group([d * tp + j for d in range(dp)]) for j in range(tp)]
        dp_group = groups[rank % tp]
    return TpMesh(dp, tp, rank // tp, rank % tp, tp_group, dp_group)


def _out_axes(module: nn.Module) -> Dict[str, int]:
    """The output-channel axis of each weight of a conv or dense layer, and
    of its bias."""
    if isinstance(module, (layers.Conv, layers.Dense, layers.FusedResampleConv)):
        axes = {"weight": 0}
        if getattr(module, "bias", None) is not None:
            axes["bias"] = 0
        return axes
    if isinstance(module, layers.NIN):
        return {"W": 1, "b": 0}
    return {}


def tp_shardings(score_model: nn.Module, tp: int) -> Dict[str, Optional[int]]:
    """The axis each parameter of ``score_model`` is split on over ``tp``
    ranks, or None where it stays whole (see the module's docstring)."""
    out = {name: None for name, _ in score_model.named_parameters()}
    for mod_name, module in score_model.named_modules():
        axes = _out_axes(module)
        if not axes:
            continue
        w = getattr(module, "W" if isinstance(module, layers.NIN) else "weight")
        n_out = w.shape[axes["W" if isinstance(module, layers.NIN) else "weight"]]
        if tp > 1 and n_out % tp == 0 and w.numel() > tp:
            for pname, axis in axes.items():
                out[f"{mod_name}.{pname}" if mod_name else pname] = axis
    return out


def _gather_channels(t: torch.Tensor, tm: TpMesh) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(tm.tp)]
    dist.all_gather(parts, t.contiguous(), group=tm.tp_group)
    return torch.cat(parts, dim=-1)


def shard_tp(score_model: nn.Module, tm: TpMesh) -> Dict[str, Optional[int]]:
    """Keep this rank's slice of every split weight and bias of
    ``score_model`` (equal on every rank before) and all-gather each split
    layer's output channels over the tp group after its forward. Returns
    the shardings (``tp_shardings``)."""
    specs = tp_shardings(score_model, tm.tp)
    if tm.tp == 1:
        return specs
    for mod_name, module in score_model.named_modules():
        split = False
        for pname in _out_axes(module):
            axis = specs.get(f"{mod_name}.{pname}" if mod_name else pname)
            if axis is None:
                continue
            p = getattr(module, pname)
            part = p.detach().chunk(tm.tp, axis)[tm.tp_index].clone()
            setattr(module, pname, nn.Parameter(part, requires_grad=p.requires_grad))
            split = True
        if split:
            module.register_forward_hook(lambda m, args, out: _gather_channels(out, tm))
    return specs


def _draw_noise(model, batch: int, n_samples: int, generator, kw) -> Dict[str, torch.Tensor]:
    """The standard-normal draws of pc_sample for the whole batch, in its
    ``noise`` layout: the prior, each step's corrector draws, each step's
    predictor draw."""
    n = kw.get("N") or model.sde.N
    steps = int(kw.get("corrector_steps", 1))
    shape = (batch, model.sde.ndim, n_samples)
    dev = model.device
    return {"prior": torch.randn(shape, generator=generator, device=dev),
            "corrector": torch.randn((n, steps, *shape), generator=generator, device=dev),
            "predictor": torch.randn((n, *shape), generator=generator, device=dev)}


def _pad_noise(noise: Dict[str, torch.Tensor], batch: int) -> Dict[str, torch.Tensor]:
    """``noise`` with its batch axis padded with zeros to ``batch`` rows
    (the draws of the rows padded onto the batch)."""
    out = {}
    for k, v in noise.items():
        v = torch.as_tensor(v)
        axis = _NOISE_BATCH_AXIS[k]
        pad = batch - v.shape[axis]
        if pad > 0:
            shape = list(v.shape)
            shape[axis] = pad
            v = torch.cat([v, v.new_zeros(shape)], dim=axis)
        out[k] = v
    return out


def make_tp_separate(model, dp: int = 1, tp: Optional[int] = None, **sampler_kwargs):
    """Shard ``model`` (a ``DiffSepModel``, the same weights on every rank)
    over a (dp, tp) layout of the process group (``tp`` defaults to the
    world size over ``dp``) and return ``run(generator, mix) -> (est,
    nfe)``: the (batch, 1, n) mixtures, the same on every rank, padded to a
    multiple of dp; each tp group separates its dp slice of rows and the
    slices are gathered, so every rank returns the whole batch's estimates.
    Every rank calls ``run`` with a generator in the same state. With dp = 1
    it draws as ``model.separate(mix, generator=...)`` does; with dp > 1
    every rank draws the whole batch's noise from it (pc_sample's layout)
    and takes its rows, so the result is ``model.separate(mix, noise=...)``
    of those draws. ``noise`` (pc_sample's layout, for the batch's rows)
    replaces the draws."""
    if tp is None:
        tp = mesh.world_size() // dp
    tm = make_mesh_2d(dp, tp)
    shard_tp(model.score_model, tm)

    def run(generator: Optional[torch.Generator], mix, noise: Optional[Dict[str, torch.Tensor]] = None):
        mix = np.asarray(mix.cpu() if torch.is_tensor(mix) else mix, dtype=np.float32)
        mix_p, real = pad_batch_to_devices(mix, tm.dp)
        if tm.dp == 1:
            est, nfe = model.separate(mix_p, generator=generator, noise=noise, **sampler_kwargs)
            return est[:real], nfe
        per = mix_p.shape[0] // tm.dp
        rows = slice(tm.dp_index * per, (tm.dp_index + 1) * per)
        if noise is None:
            kw = model._sampler_kwargs(sampler_kwargs)
            noise = _draw_noise(model, mix_p.shape[0], mix_p.shape[-1], generator, kw)
        noise = _pad_noise(noise, mix_p.shape[0])
        est, nfe = model.separate(mix_p[rows], noise=_slice_noise(noise, rows.start, rows.stop), **sampler_kwargs)
        parts: List[torch.Tensor] = [torch.empty_like(est) for _ in range(tm.dp)]
        dist.all_gather(parts, est.contiguous(), group=tm.dp_group)
        return torch.cat(parts)[:real], nfe

    run.mesh = tm
    return run
