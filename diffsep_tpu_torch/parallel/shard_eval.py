"""Batched inference over several devices.

Counterpart of ``diffsep_tpu/parallel/shard_eval.py``. The JAX package
shards the batch axis over its mesh and runs one program on every chip;
the port gives each device its own copy of the model and one thread, pads
the batch to a multiple of the device count, and hands each thread its
contiguous slice of rows. The kernels release the interpreter lock while
the cards compute, so the threads overlap. Each copy keeps its own weight
caches (``models/layers.py``'s HWIO copy is one slot per module, keyed on
the device), and every thread runs inside its device's scope
(``model.separate``).
"""
from __future__ import annotations

import copy
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..train.trainer import step_generator

__all__ = ["make_sharded_separate", "model_copies", "pad_batch_to_devices"]

# the batch axis of each entry of pc_sample's ``noise``
_NOISE_BATCH_AXIS = {"prior": 0, "corrector": 2, "predictor": 1}


def pad_batch_to_devices(batch: np.ndarray, n_devices: int):
    """Pad the leading axis with zeros to a multiple of the device count;
    returns (padded, real_count)."""
    b = batch.shape[0]
    target = -(-b // n_devices) * n_devices
    if target != b:
        batch = np.pad(batch, [(0, target - b)] + [(0, 0)] * (batch.ndim - 1))
    return batch, b


def model_copies(model, devices: Sequence) -> List:
    """One model per entry of ``devices``: ``model`` itself for the first
    entry on its own device, a copy on its device for every other entry (a
    device named twice gets two copies, for two threads)."""
    out = []
    for i, dev in enumerate(devices):
        dev = torch.device(dev)
        if i == 0 and dev == model.device:
            out.append(model)
            continue
        m = copy.deepcopy(model)
        m.score_model.to(dev)
        m.device = next(m.score_model.parameters()).device
        out.append(m)
    return out


def _slice_noise(noise: Optional[Dict[str, torch.Tensor]], start: int, stop: int):
    if noise is None:
        return None
    out = {}
    for k, v in noise.items():
        index = [slice(None)] * v.ndim
        index[_NOISE_BATCH_AXIS[k]] = slice(start, stop)
        out[k] = v[tuple(index)]
    return out


def make_sharded_separate(model, devices: Sequence, **sampler_kwargs):
    """A callable (mix, seed=0, noise=None) -> (estimates, nfe) that splits
    the (batch, 1, n) mixtures over one model copy per entry of ``devices``
    and separates each slice in a thread of its own. The batch is padded to
    a multiple of the device count; the real rows come back in order, as a
    CPU tensor. Slice p draws from ``step_generator(seed, p)``; ``noise``
    (pc_sample's layout, for the whole padded batch) replaces the draws."""
    models = model_copies(model, devices)
    n_dev = len(models)

    def run(mix, seed: int = 0, noise: Optional[Dict[str, torch.Tensor]] = None):
        mix_p, real = pad_batch_to_devices(np.asarray(mix, dtype=np.float32), n_dev)
        per = mix_p.shape[0] // n_dev
        results: List = [None] * n_dev
        errors: List[Exception] = []

        def work(p: int):
            try:
                m = models[p]
                rows = slice(p * per, (p + 1) * per)
                est, nfe = m.separate(mix_p[rows], generator=step_generator(seed, p, m.device),
                                      noise=_slice_noise(noise, rows.start, rows.stop), **sampler_kwargs)
                results[p] = (est.cpu(), nfe)
            except Exception as e:  # raised in the caller's thread below
                errors.append(e)

        threads = [threading.Thread(target=work, args=(p,), daemon=True) for p in range(n_dev)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        est = torch.cat([r[0] for r in results])[:real]
        return est, results[0][1]

    return run
