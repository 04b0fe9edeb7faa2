"""Joining a process group: one process per GPU.

Counterpart of ``diffsep_tpu/utils/distributed.py``. The JAX package starts
its multi-host runtime from the cluster's environment; the port joins a
``torch.distributed`` process group, from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or from the
arguments a spawning parent passes (``cli/train.py``).
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..parallel import mesh

log = logging.getLogger(__name__)

__all__ = ["initialize_distributed", "is_rank_zero", "torchrun_env"]


def is_rank_zero() -> bool:
    """True on the process that writes logs, checkpoints and hparams."""
    return mesh.rank() == 0


def torchrun_env() -> bool:
    """Whether torchrun (or another launcher with its variables) started
    this process."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize_distributed(backend: Optional[str] = None, device_type: str = "cuda", rank: Optional[int] = None,
                           world_size: Optional[int] = None, init_method: Optional[str] = None,
                           device_index: Optional[int] = None) -> bool:
    """Join a process group; a no-op (returns False) when neither torchrun's
    environment nor ``rank``/``world_size`` is given.

    ``backend`` defaults to NCCL for ``device_type`` "cuda" and gloo for
    "cpu"; gloo also carries CUDA tensors where several ranks share one card,
    which NCCL refuses. Under CUDA the current device becomes
    ``device_index`` (default: ``LOCAL_RANK``). A group that fails to form
    raises; every collective of the group times out after
    ``mesh.TIMEOUT``."""
    if rank is None and world_size is None and not torchrun_env():
        return False
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    if rank is None:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    elif world_size is None or init_method is None:
        raise ValueError("a spawned rank needs rank, world_size and init_method")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass trainer.accelerator=cpu to train on the CPU")
        if device_index is None:
            device_index = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(device_index)
    elif device_type != "cpu":
        raise ValueError(f"device_type {device_type!r}: expected 'cuda' or 'cpu'")
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=mesh.TIMEOUT)
    log.info("rank %d of %d joined the %s group%s", rank, world_size, backend,
             f" on cuda:{device_index}" if device_type == "cuda" else "")
    return True
