"""Process-group helpers of data-parallel training.

Counterpart of ``diffsep_tpu/parallel/mesh.py``. The JAX package runs data
parallelism as a ``dp`` mesh axis: one program over every device, the
gradient's mean inserted by the compiler. The port follows the reference's
Lightning DDP instead, the idiom on GPUs: one process per GPU, each joined
to a ``torch.distributed`` process group (``utils/distributed.py``), the
score model wrapped in ``DistributedDataParallel``, which averages the
gradients over the ranks in every backward. Each rank takes ``batch_size``
rows of its own loader shard, so the global batch is world x batch_size.

Without a process group every helper here is the single-process identity:
world size 1, rank 0, no wrap.
"""
from __future__ import annotations

import datetime
from typing import List, Optional

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["all_reduce_mean", "any_rank", "barrier", "broadcast_object", "rank", "replicate_global",
           "world_size", "wrap_ddp"]

# how long a rank waits in a collective before it raises: a rank that died
# fails the others instead of leaving them blocked
TIMEOUT = datetime.timedelta(minutes=10)


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if _active() else 1


def rank() -> int:
    return dist.get_rank() if _active() else 0


def _collective_device() -> torch.device:
    """Where the group's small host-value collectives put their tensor: the
    current card under NCCL, which takes CUDA tensors only; the CPU under
    gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if _active():
        dist.barrier()


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` (picklable) on every rank."""
    if not _active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` is true on some rank (every rank must call)."""
    if not _active():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks, in place (a sum divided by the
    world size: gloo has no average)."""
    if _active() and world_size() > 1:
        dist.all_reduce(t)
        t /= world_size()
    return t


def _state_tensors(state) -> List[torch.Tensor]:
    """Every tensor of a TrainState, in a fixed order: the parameters (the
    Fourier projection's W too, which DDP does not register), the EMA, the
    optimizer's moments and accumulator, the clipper's history."""
    opt = state.optimizer
    tensors = [*state.params, *state.ema.params, *opt.mu, *opt.nu]
    if opt.acc is not None:
        tensors += opt.acc
    if state.clip_state is not None:
        tensors.append(state.clip_state.history)
    return tensors


@torch.no_grad()
def replicate_global(state):
    """Rank 0's train state on every rank: its parameters, EMA, optimizer
    and clipper tensors broadcast in place, and its counters. Every rank then
    starts equal, as the JAX package's ``replicate_global`` places one state
    on every device. Returns ``state``."""
    if not _active() or world_size() == 1:
        return state
    for t in _state_tensors(state):
        dist.broadcast(t.data, src=0)
    opt = state.optimizer
    counters = broadcast_object([state.step, opt.count, opt.mini_step, opt.gradient_step,
                                 state.ema.num_updates,
                                 state.clip_state.count if state.clip_state is not None else None])
    state.step, opt.count, opt.mini_step, opt.gradient_step, state.ema.num_updates, clip_count = counters
    if state.clip_state is not None:
        state.clip_state.count = clip_count
    return state


def wrap_ddp(module: nn.Module, device: Optional[torch.device] = None) -> nn.Module:
    """``module`` in ``DistributedDataParallel`` under a process group of
    more than one rank, else ``module`` itself.

    Each training loss calls the network once, so the graph is the same in
    every step (``static_graph``): DDP learns in the first backward which
    parameters take no gradient (DiffuSE's last residual conv, whose output
    nothing reads; the JAX package gives it a zero gradient) and leaves
    them out of the later all-reduces without searching the graph again.
    Buffers are constants (the FIR taps, the step-embedding table), so they
    are not broadcast before every forward."""
    if world_size() == 1:
        return module
    device = device if device is not None else next(module.parameters()).device
    device_ids = [device.index] if device.type == "cuda" else None
    return nn.parallel.DistributedDataParallel(module, device_ids=device_ids, broadcast_buffers=False,
                                               static_graph=True)


def fsdp_unsupported() -> NotImplementedError:
    return NotImplementedError(
        "trainer.strategy=fsdp (the JAX package's fsdp_shardings) is not ported to diffsep_tpu_torch "
        "(ROADMAP.md, queue 1 item 8.1); use strategy: ddp")
