"""Batch-norm statistics recomputed over a loader (after weight averaging).

Counterpart of ``diffsep_tpu/utils/bn_update.py``: one pass over the loader
sets every batch-norm running statistic to the mean of the per-batch
statistics weighted by batch size, the reference's SWA ``bn_update``. As
there, each batch's statistics are taken in train mode (the unbiased
variance goes into ``running_var``) and folded in with momentum b / (n + b)
from reset statistics, which is that weighted mean exactly; torch's
``swa_utils.update_bn`` averages over batches unweighted instead. A module
without batch norm is returned unchanged without reading the loader.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch
from torch import nn


def _default_batch_arg(batch):
    return batch[0] if isinstance(batch, (list, tuple)) else batch


def bn_update(loader: Iterable, module: nn.Module, batch_arg: Callable = _default_batch_arg) -> nn.Module:
    """Recompute the running statistics of every batch norm in ``module``
    by streaming ``loader`` through it. ``batch_arg(batch)`` gives the
    module's input, or a tuple of its inputs (e.g. (x, y) for a
    class-conditional block); the first input's leading axis is the batch
    size. Inputs go to the device of the module's buffers."""
    norms = [m for m in module.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    if not norms:
        return module
    device = next(module.buffers()).device
    momenta = [m.momentum for m in norms]
    was_training = module.training
    for m in norms:
        m.reset_running_stats()
    module.train()
    n = 0
    try:
        with torch.no_grad():
            for batch in loader:
                inputs = batch_arg(batch)
                inputs = inputs if isinstance(inputs, tuple) else (inputs,)
                inputs = tuple(torch.as_tensor(a, device=device) for a in inputs)
                b = inputs[0].shape[0]
                for m in norms:
                    m.momentum = b / (n + b)
                module(*inputs)
                n += b
    finally:
        for m, mom in zip(norms, momenta):
            m.momentum = mom
        module.train(was_training)
    return module
