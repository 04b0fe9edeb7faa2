"""JAX param tree -> state dict of the port.

Counterpart of ``flax_to_score_model_state_dict`` in
``diffsep_tpu/models/convert.py``: the port's parameter names and layouts
are those of the reference torch checkpoints, so the mapping is a rename
plus a transpose per leaf:

  flax Conv kernel (kh, kw, I, O) -> Conv weight (O, I, kh, kw)
  flax Dense kernel (I, O)        -> Dense weight (O, I)
  flax GroupNorm scale            -> GroupNorm weight
  NIN W/b, Fourier W, biases      -> unchanged

``train_state_from_jax`` carries a whole JAX ``TrainState`` across: the
parameters, the EMA shadow and its count, Adam's moments and count,
``optax.MultiSteps``'s accumulated gradient and counters, and AutoClip's
history, each tree of parameter shape through the same mapping. Both
packages can then take the same step from the same state.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "train_state_from_jax"]


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _deconvert_leaf(path: Tuple[str, ...], arr: np.ndarray):
    """One flax (path, array) -> one torch (path, array)."""
    name = path[-1]
    if name == "kernel":
        if arr.ndim == 4:
            return path[:-1] + ("weight",), arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:
            return path[:-1] + ("weight",), arr.T
        raise ValueError(f"Unhandled kernel shape {arr.shape} at {path}")
    if name == "scale":
        return path[:-1] + ("weight",), arr
    if name in ("bias", "W", "b"):
        return path, arr
    raise ValueError(f"Unhandled parameter {path}")


def _module_index_unrename(path: Tuple[str, ...]) -> str:
    """('all_modules_<i>', *rest) -> 'all_modules.<i>.rest'."""
    out = []
    for p in path:
        if p.startswith("all_modules_") and p[len("all_modules_"):].isdigit():
            out += ["all_modules", p[len("all_modules_"):]]
        else:
            out.append(p)
    return ".".join(out)


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``ScoreModelNCSNpp`` params (backbone under 'backbone', numpy or
    jax arrays) -> ``ScoreModelNCSNpp.state_dict()`` of the port."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params["backbone"]):
        path, arr = _deconvert_leaf(path, np.asarray(arr, np.float32))
        out["backbone." + _module_index_unrename(path)] = torch.from_numpy(
            np.array(arr, np.float32, order="C")
        )
    return out


def _find_adam(node):
    """The ``ScaleByAdamState`` (count, mu, nu) inside an optax state."""
    if hasattr(node, "mu") and hasattr(node, "nu"):
        return node
    if isinstance(node, tuple):
        for child in node:
            found = _find_adam(child)
            if found is not None:
                return found
    return None


def train_state_from_jax(state, model):
    """A JAX ``TrainState`` (numpy or jax arrays) -> the port's TrainState
    for ``model`` (a ``DiffSepModel``), whose parameters it loads."""
    model.score_model.load_state_dict(state_dict_from_jax(state.params), strict=True)
    ts = model.init_state()
    opt = state.opt_state
    multi = opt if hasattr(opt, "acc_grads") else None
    adam = _find_adam(multi.inner_opt_state if multi is not None else opt)
    clip = None
    if hasattr(state.clip_state, "history"):
        clip = {"history": torch.from_numpy(np.array(state.clip_state.history, np.float32)),
                "count": int(state.clip_state.count)}
    ts.load_state_dict({
        "step": int(state.step),
        "optimizer": {
            "mu": state_dict_from_jax(adam.mu), "nu": state_dict_from_jax(adam.nu), "count": int(adam.count),
            "acc": state_dict_from_jax(multi.acc_grads) if multi is not None else None,
            "mini_step": int(multi.mini_step) if multi is not None else 0,
            "gradient_step": int(multi.gradient_step) if multi is not None else 0,
        },
        "ema": {"params": state_dict_from_jax(state.ema.params), "num_updates": int(state.ema.num_updates)},
        "clip": clip,
    })
    return ts
