"""Process-group helpers of data-parallel training.

Counterpart of ``diffsep_tpu/parallel/mesh.py``. The JAX package runs data
parallelism as a ``dp`` mesh axis: one program over every device, the
gradient's mean inserted by the compiler. The port follows the reference's
Lightning DDP instead, the idiom on GPUs: one process per GPU, each joined
to a ``torch.distributed`` process group (``utils/distributed.py``), the
score model wrapped in ``DistributedDataParallel``, which averages the
gradients over the ranks in every backward. Each rank takes ``batch_size``
rows of its own loader shard, so the global batch is world x batch_size.

``trainer.strategy: fsdp`` shards instead (``FsdpLayout``): each parameter
of at least ``fsdp_min_size`` elements is split over the ranks on the axis
the JAX package's ``fsdp_shardings`` picks, with FSDP2's ``fully_shard``
(all-gathered for each forward, gradients reduce-scattered); its Adam
moments, accumulator and EMA are split alike, and smaller parameters stay
replicated, their gradients averaged here.

Without a process group every helper here is the single-process identity:
world size 1, rank 0, no wrap.
"""
from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["FsdpLayout", "all_reduce_mean", "any_rank", "barrier", "broadcast_object", "fsdp_shard_dims",
           "rank", "replicate_global", "shard_fsdp", "world_size", "wrap_ddp"]

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


def fsdp_shard_dims(shapes: Sequence[Sequence[int]], n: int, min_size: int = 2 ** 16) -> List[Optional[int]]:
    """The axis each parameter is split on over ``n`` ranks, or None where it
    stays replicated: the rule of the JAX package's ``fsdp_shardings``. A
    parameter of fewer than ``min_size`` elements (or 0-dim) is replicated;
    a larger one is split on its largest axis that ``n`` divides (the first
    of equal ones), replicated where none does."""
    dims = []
    for shape in shapes:
        size = 1
        for s in shape:
            size *= int(s)
        cands = [(d, int(s)) for d, s in enumerate(shape) if int(s) % n == 0]
        if len(shape) == 0 or size < min_size or not cands:
            dims.append(None)
        else:
            dims.append(max(cands, key=lambda c: c[1])[0])
    return dims


class FsdpLayout:
    """Where each parameter of a train state lives under ``fully_shard``.

    ``params`` are the module's parameters after sharding, in the train
    state's order: DTensors split on ``dims[i]``, or plain replicated
    tensors where ``dims[i]`` is None. ``local`` are what the optimizer, the
    EMA and the clipper act on: each sharded parameter's local shard (a view
    of the storage that FSDP all-gathers for every forward, so an update in
    place reaches the next forward) and each replicated parameter itself.
    """

    def __init__(self, params: Sequence[nn.Parameter], dims: Sequence[Optional[int]]):
        from torch.distributed.tensor import DTensor

        self.params = list(params)
        self.dims = list(dims)
        self.world, self.rank = world_size(), rank()
        for p, d in zip(self.params, self.dims):
            if isinstance(p, DTensor) != (d is not None):
                raise RuntimeError("FsdpLayout: a parameter's sharding differs from its planned axis")
        with torch.no_grad():
            self.local = [p.to_local() if d is not None else p for p, d in zip(self.params, self.dims)]

    def shard(self, full: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's part of ``full``, the whole of parameter i's tensor
        (a copy)."""
        d = self.dims[i]
        return full.detach().clone() if d is None else full.detach().chunk(self.world, d)[self.rank].clone()

    def gather(self, local: torch.Tensor, i: int) -> torch.Tensor:
        """The whole tensor of parameter i from every rank's ``local`` part
        (every rank calls, in the same order)."""
        d = self.dims[i]
        if d is None:
            return local.detach().clone()
        moved = local.detach().movedim(d, 0).contiguous()
        out = torch.empty((self.world * moved.shape[0], *moved.shape[1:]), dtype=moved.dtype,
                          device=moved.device)
        dist.all_gather_into_tensor(out, moved)
        return out.movedim(0, d).contiguous()

    def grads(self) -> List[torch.Tensor]:
        """This rank's gradient of each ``local`` tensor: the sharded ones
        reduce-scattered (mean over ranks) by FSDP in the backward, the
        replicated ones averaged here in one all-reduce; zeros where a
        parameter took none."""
        out = []
        for p, d, loc in zip(self.params, self.dims, self.local):
            g = p.grad
            if g is None:
                out.append(torch.zeros_like(loc))
            else:
                out.append(g.to_local() if d is not None else g)
        rep = [g for g, d in zip(out, self.dims) if d is None]
        if rep and self.world > 1:
            flat = all_reduce_mean(torch.cat([g.reshape(-1) for g in rep]))
            for g, v in zip(rep, flat.split([g.numel() for g in rep])):
                g.copy_(v.view_as(g))
        return out

    def global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The L2 norm of the whole gradient, from every rank's ``grads``
        (the replicated ones counted once), in float32."""
        sq = torch._foreach_norm([g.float() for g in grads])
        sharded = [n for n, d in zip(sq, self.dims) if d is not None]
        replicated = [n for n, d in zip(sq, self.dims) if d is None]
        total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        if sharded:
            total = torch.stack(sharded).square().sum()
            if self.world > 1:
                dist.all_reduce(total)
        if replicated:
            total = total + torch.stack(replicated).square().sum()
        return total.sqrt()


def shard_fsdp(module: nn.Module, names: Sequence[str], min_size: int = 2 ** 16) -> FsdpLayout:
    """Shard ``module``'s parameters over the process group with FSDP2
    (``fully_shard`` on the module: one all-gather per forward, gradients
    reduce-scattered to their mean), split as ``fsdp_shard_dims`` says; the
    others stay replicated (``ignored_params``). ``names`` orders the
    layout's parameters (the train state's order). Every rank calls it with
    equal parameters (``replicate_global`` first)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    n = world_size()
    by_name = dict(module.named_parameters())
    dims = fsdp_shard_dims([tuple(by_name[k].shape) for k in names], n, min_size)
    dim_of: Dict[int, Optional[int]] = {id(by_name[k]): d for k, d in zip(names, dims)}
    device = by_name[names[0]].device
    group_mesh = init_device_mesh(device.type, (n,))
    # resharded after every forward, also the root's and one without grad:
    # the state's updates (the optimizer, the EMA swapped in for validation)
    # write the shards, so an unsharded copy kept past a forward would
    # give the next forward stale weights
    fully_shard(module, mesh=group_mesh, reshard_after_forward=True,
                shard_placement_fn=lambda p: Shard(dim_of[id(p)]),
                ignored_params={by_name[k] for k, d in zip(names, dims) if d is None})
    # a copy of a weight kept between forwards (models/layers.Conv) is keyed
    # on the parameter's storage and version, and the all-gather refills
    # that storage without a new version: each forward makes its own
    for m in module.modules():
        if getattr(m, "keep_weight_copy", False):
            m.keep_weight_copy = False
    by_name = dict(module.named_parameters())
    return FsdpLayout([by_name[k] for k in names], dims)
