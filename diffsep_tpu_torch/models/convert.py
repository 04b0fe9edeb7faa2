"""JAX param tree -> state dict of the port.

Counterpart of ``flax_to_score_model_state_dict`` in
``diffsep_tpu/models/convert.py``: the port's parameter names and layouts
are those of the reference torch checkpoints, so the mapping is a rename
plus a transpose per leaf:

  flax Conv kernel (kh, kw, I, O) -> Conv weight (O, I, kh, kw)
  flax Dense kernel (I, O)        -> Dense weight (O, I)
  flax GroupNorm scale            -> GroupNorm weight
  NIN W/b, Fourier W, biases      -> unchanged
  fused resample ``Conv2d_0`` weight (OIHW already) -> unchanged
  the learnable transform scalars ``spec_abs_exponent``, ``spec_factor``
                                  -> unchanged, outside the backbone

``state_dicts_from_reference`` reads a reference Lightning checkpoint
(``score_model.*`` keys in the port's own layout, and the EMA shadow list
``ema.shadow_params``) into the port's state dict, raw and EMA;
``save_reference_checkpoint`` writes one from the port's weights and config,
its ``_target_`` paths mapped to the reference's (``TO_REFERENCE_TARGETS``,
the inverse of ``FROM_REFERENCE_TARGETS``, which ``cli/loading.py`` reads).

``train_state_from_jax`` carries a whole JAX ``TrainState`` across: the
parameters, the EMA shadow and its count, Adam's moments and count,
``optax.MultiSteps``'s accumulated gradient and counters, and AutoClip's
history, each tree of parameter shape through the same mapping. Both
packages can then take the same step from the same state.

``legacy_state_dict_from_jax`` maps one block of ``legacy_layers.py`` or
``normalization.py`` (NHWC, as NCSN++): kernels and GroupNorm as above,
``Embed_0.embedding`` -> ``embed.weight``, InstanceNorm++'s and
VarianceNorm2d's ``alpha``/``gamma`` offsets from 1 -> the factors, module
lists ``convs_<i>`` -> ``convs.<i>``, and a batch norm's ``batch_stats``
``mean``/``var`` -> ``running_mean``/``running_var``.

``diffuse_state_dict_from_jax``, ``tcn_state_dict_from_jax`` and
``dptnet_state_dict_from_jax`` do the same for the other backbones, whose
port computes in (batch, channels, time):

  flax Conv kernel (k, I/groups, O)  -> Conv1d weight (O, I/groups, k)
  flax Dense kernel (I, O)           -> Linear weight (O, I)
  attention query/key/value (I, H, D), bias (H, D) -> Linear (H*D, I), (H*D,)
  attention out (H, D, O)            -> Linear (O, H*D)
  gLN/cLN gamma, beta (1, 1, C)      -> (1, C, 1); PReLU alpha () -> weight (1,)
  flax LSTM/GRU/simple cells         -> torch's packed weight_ih/weight_hh
                                        /bias_ih/bias_hh, the bias flax
                                        lacks set to zero
  module ``name_<i>``                -> ``name.<i>``
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["FROM_REFERENCE_TARGETS", "TO_REFERENCE_TARGETS", "state_dict_from_jax", "state_dicts_from_reference",
           "save_reference_checkpoint", "to_reference_config", "train_state_from_jax", "diffuse_state_dict_from_jax",
           "tcn_state_dict_from_jax", "dptnet_state_dict_from_jax", "legacy_state_dict_from_jax"]


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _deconvert_leaf(path: Tuple[str, ...], arr: np.ndarray):
    """One flax (path, array) -> one torch (path, array)."""
    name = path[-1]
    if name == "weight" and len(path) >= 2 and path[-2].startswith("Conv2d"):
        return path, arr  # FusedResampleConv keeps the torch layout
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


_TRANSFORM_SCALARS = ("spec_abs_exponent", "spec_factor")


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``ScoreModelNCSNpp`` params (backbone under 'backbone', the
    learnable transform scalars beside it; numpy or jax arrays) ->
    ``ScoreModelNCSNpp.state_dict()`` of the port."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params["backbone"]):
        path, arr = _deconvert_leaf(path, np.asarray(arr, np.float32))
        out["backbone." + _module_index_unrename(path)] = _tensor(arr)
    for key in _TRANSFORM_SCALARS:
        if key in params:
            out[key] = _tensor(params[key])
    return out


_LEGACY_LISTS = ("convs", "norms", "adapt_convs")


def legacy_state_dict_from_jax(params: Mapping[str, Any],
                               batch_stats: Mapping[str, Any] = None) -> Dict[str, torch.Tensor]:
    """A JAX legacy block's params (and, for a block holding a
    ``ConditionalBatchNorm2d``, its ``batch_stats``) -> the port block's
    ``state_dict()``, to load with ``strict=True``."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        arr = np.asarray(arr, np.float32)
        mods = [_indexed(p, _LEGACY_LISTS) for p in path[:-1]]
        name = path[-1]
        if mods and mods[-1] == "Embed_0":
            mods[-1], name = "embed", "weight"
        elif name in ("alpha", "gamma"):
            arr = arr + np.float32(1.0)
        elif name != "beta":
            (*_, name), arr = _deconvert_leaf(path, arr)
        out[".".join(mods + [name])] = _tensor(arr)
    for path, arr in _flatten(batch_stats or {}):
        prefix = ".".join(_indexed(p, _LEGACY_LISTS) for p in path[:-1])
        out[f"{prefix}.running_{path[-1]}"] = _tensor(arr)
        out[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return out


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, np.float32, order="C"))


def _leaf_1d(name: str, arr: np.ndarray):
    """(torch name, array) of one leaf of a (batch, time, channels) flax
    module computing in (batch, channels, time) in the port."""
    if name == "kernel":
        if arr.ndim == 3:  # Conv (k, I, O) -> (O, I, k)
            return "weight", arr.transpose(2, 1, 0)
        if arr.ndim == 4:  # Conv (1, 1, I, O) -> (O, I, 1, 1)
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:
            return "weight", arr.T
        raise ValueError(f"Unhandled kernel shape {arr.shape}")
    if name in ("gamma", "beta"):  # (1, 1, C) -> (1, C, 1)
        return name, arr.transpose(0, 2, 1)
    if name == "alpha":
        return "weight", arr.reshape(1)
    if name == "scale":
        return "weight", arr
    if name == "bias":
        return name, arr
    raise ValueError(f"Unhandled parameter {name}")


def _indexed(part: str, names) -> str:
    """``name_<i>`` -> ``name.<i>`` for a module list named in ``names``."""
    stem, _, idx = part.rpartition("_")
    return f"{stem}.{idx}" if stem in names and idx.isdigit() else part


def _convert_1d(params: Mapping[str, Any], rename) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        name, arr = _leaf_1d(path[-1], np.asarray(arr, np.float32))
        out[".".join(rename(p) for p in path[:-1]) + "." + name] = _tensor(arr)
    return out


def diffuse_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``DiffuSE`` params -> ``DiffuSE.state_dict()``; a JAX
    ``ScoreModelDiffuSE`` tree (the backbone under 'backbone') ->
    ``ScoreModelDiffuSE.state_dict()``."""
    if "backbone" in params:
        return {"backbone." + k: v for k, v in diffuse_state_dict_from_jax(params["backbone"]).items()}
    return _convert_1d(params, lambda p: _indexed(p, ("residual_layers",)))


# flax's auto-named modules: a norm of choose_norm, an RNN cell of DPTNet
_NORMS = ("GlobalLayerNorm", "ChannelwiseLayerNorm", "GroupNorm")
_CELLS = ("OptimizedLSTMCell", "GRUCell", "SimpleCell")


def tcn_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``TemporalConvNet`` params -> ``TemporalConvNet.state_dict()``."""

    def rename(part):
        m = re.fullmatch(r"repeat_(\d+)_block_(\d+)", part)
        if m:
            return f"repeats.{m.group(1)}.{m.group(2)}"
        return "norm" if part.rpartition("_")[0] in _NORMS else part

    return _convert_1d(params, rename)


def _rnn_weights(cells: Mapping[str, Any], suffix: str) -> Dict[str, np.ndarray]:
    """One direction of a flax RNN cell -> torch's packed RNN weights (gate
    order i, f, g, o for the LSTM; r, z, n for the GRU)."""
    def k(name):
        return np.asarray(cells[name]["kernel"], np.float32).T

    def b(name):
        return np.asarray(cells[name]["bias"], np.float32)

    if "ii" in cells:  # OptimizedLSTMCell: the input kernels have no bias
        w_ih = np.concatenate([k(n) for n in ("ii", "if", "ig", "io")])
        w_hh = np.concatenate([k(n) for n in ("hi", "hf", "hg", "ho")])
        b_ih = np.zeros(w_ih.shape[0], np.float32)
        b_hh = np.concatenate([b(n) for n in ("hi", "hf", "hg", "ho")])
    elif "ir" in cells:  # GRUCell: hr, hz have no bias
        w_ih = np.concatenate([k(n) for n in ("ir", "iz", "in")])
        w_hh = np.concatenate([k(n) for n in ("hr", "hz", "hn")])
        b_ih = np.concatenate([b(n) for n in ("ir", "iz", "in")])
        zero = np.zeros_like(b("hn"))
        b_hh = np.concatenate([zero, zero, b("hn")])
    else:  # SimpleCell: h has no bias
        w_ih, w_hh, b_ih = k("i"), k("h"), b("i")
        b_hh = np.zeros_like(b_ih)
    return {f"weight_ih_l0{suffix}": w_ih, f"weight_hh_l0{suffix}": w_hh,
            f"bias_ih_l0{suffix}": b_ih, f"bias_hh_l0{suffix}": b_hh}


def _attention(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """flax ``MultiHeadDotProductAttention`` -> ``dptnet.MultiHeadAttention``:
    the (in, heads, head_dim) projections and the (heads, head_dim, out)
    output flattened over the heads."""
    out = {}
    for proj in ("query", "key", "value"):
        kern = np.asarray(params[proj]["kernel"], np.float32)
        out[f"{proj}.weight"] = kern.reshape(kern.shape[0], -1).T
        out[f"{proj}.bias"] = np.asarray(params[proj]["bias"], np.float32).reshape(-1)
    kern = np.asarray(params["out"]["kernel"], np.float32)
    out["out.weight"] = kern.reshape(-1, kern.shape[-1]).T
    out["out.bias"] = np.asarray(params["out"]["bias"], np.float32)
    return out


def dptnet_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``DPTNet`` params -> ``DPTNet.state_dict()``. In a transformer
    layer the norms are ``norm1``, ``norm2`` in call order, and an RNN's
    first cell is its forward direction, the second (bidirectional only)
    the backward one."""
    out: Dict[str, torch.Tensor] = {}

    def leaves(sub, prefix):
        for leaf, arr in sub.items():
            name, arr = _leaf_1d(leaf, np.asarray(arr, np.float32))
            out[f"{prefix}.{name}"] = _tensor(arr)

    for top, layer in params.items():
        if top.rpartition("_")[0] not in ("row_transformer", "col_transformer"):
            leaves(layer, top)  # the output PReLU and conv
            continue
        prefix = _indexed(top, ("row_transformer", "col_transformer"))
        for name, sub in layer.items():
            stem, _, idx = name.rpartition("_")
            if name == "self_attn":
                out.update({f"{prefix}.self_attn.{k}": _tensor(v) for k, v in _attention(sub).items()})
            elif stem in _CELLS:
                suffix = "_reverse" if idx == "1" else ""
                out.update({f"{prefix}.rnn.{k}": _tensor(v) for k, v in _rnn_weights(sub, suffix).items()})
            else:
                leaves(sub, f"{prefix}.norm{int(idx) + 1}" if stem in _NORMS else f"{prefix}.{name}")
    return out


def _reference_trainable_keys(state_dict: Mapping[str, Any]):
    """The keys ``ema.shadow_params`` runs over: the reference's trainable
    parameters in ``state_dict`` order, which leaves out the STFT window
    buffers and the frozen Fourier projection ``all_modules.0.W`` (the
    JAX package's ``convert_ema_backbone``)."""
    return [k for k in state_dict if ".stft" not in k and not k.endswith("all_modules.0.W")]


def state_dicts_from_reference(ckpt: Mapping[str, Any], prefix: str = "score_model."):
    """A reference Lightning checkpoint (``state_dict``, optionally ``ema``)
    -> (raw, EMA or None) state dicts of the port's ``ScoreModelNCSNpp``.
    The EMA one takes ``all_modules.0.W``, which is not averaged, raw."""
    sd = ckpt["state_dict"]
    raw = {k[len(prefix):]: torch.as_tensor(v, dtype=torch.float32) for k, v in sd.items()
           if k.startswith(prefix) and ".stft" not in k}
    shadow = (ckpt.get("ema") or {}).get("shadow_params")
    if shadow is None:
        return raw, None
    keys = _reference_trainable_keys(sd)
    if len(keys) != len(shadow):
        raise ValueError(f"EMA shadow list has {len(shadow)} entries but "
                         f"{len(keys)} trainable parameters were found")
    ema = dict(raw)
    ema.update({k[len(prefix):]: torch.as_tensor(v, dtype=torch.float32)
                for k, v in zip(keys, shadow) if k.startswith(prefix)})
    return raw, ema


# the reference's torch import paths -> the port's classes
FROM_REFERENCE_TARGETS = {
    "models.score_models.ScoreModelNCSNpp": "diffsep_tpu_torch.models.ScoreModelNCSNpp",
    "models.ncsnpp.NCSNpp": "diffsep_tpu_torch.models.NCSNpp",
    "sdes.sdes.MixSDE": "diffsep_tpu_torch.sde.MixSDE",
    "sdes.sdes.PriorMixSDE": "diffsep_tpu_torch.sde.PriorMixSDE",
    "sdes.sdes.OUVESDE": "diffsep_tpu_torch.sde.OUVESDE",
    "sdes.sdes.OUVPSDE": "diffsep_tpu_torch.sde.OUVPSDE",
    "models.losses.SISDRLoss": "diffsep_tpu_torch.models.losses.SISDRLoss",
    "models.losses.PESQ": "diffsep_tpu_torch.models.losses.PESQ",
    "utils.FixedClipper": "diffsep_tpu_torch.train.clippers.FixedClipper",
    "utils.AutoClipper": "diffsep_tpu_torch.train.clippers.AutoClipper",
    "torch.optim.Adam": "adam",
    "torch.nn.MSELoss": "mse",
}
# the port's config names -> the reference's, so that a checkpoint written
# here instantiates under the reference's hydra config loading; a target
# the reference has no class for (the datamodule's, DiffuSE's) is kept
TO_REFERENCE_TARGETS = {port: ref for ref, port in FROM_REFERENCE_TARGETS.items()}


def to_reference_config(node):
    """A config tree (dicts and lists) with every ``_target_`` the
    reference has mapped to its import path."""
    if isinstance(node, Mapping):
        return {k: TO_REFERENCE_TARGETS.get(v, v) if k == "_target_" else to_reference_config(v)
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [to_reference_config(v) for v in node]
    return node


def save_reference_checkpoint(path, state_dict: Mapping[str, torch.Tensor], config=None) -> None:
    """Write a reference Lightning checkpoint from the port's score-model
    weights (pass the evaluation, EMA, weights: the reference falls back to
    the raw ones where a checkpoint has no ``ema`` section): ``state_dict``
    with ``score_model.*`` keys, ``global_step`` and ``epoch`` 0, and, where
    ``config`` (the composed run config as plain dicts) is given,
    ``hyper_parameters.config`` with the reference's ``_target_`` paths. The
    JAX package's ``save_reference_checkpoint`` writes the same layout, and
    ``cli/loading.py`` reads it back."""
    ckpt: Dict[str, Any] = {
        "state_dict": {"score_model." + k: v.detach().cpu().float().contiguous().clone()
                       for k, v in state_dict.items()},
        "global_step": 0, "epoch": 0,
    }
    if config is not None:
        ckpt["hyper_parameters"] = {"config": to_reference_config(config)}
    torch.save(ckpt, str(path))


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
    for ``model`` (a ``DiffSepModel``), whose parameters it loads. Each tree
    of parameter shape goes through the converter of the model's family:
    ``diffuse_state_dict_from_jax`` for a DiffuSE score model,
    ``state_dict_from_jax`` for NCSN++."""
    from .score_model_diffuse import ScoreModelDiffuSE

    convert = diffuse_state_dict_from_jax if isinstance(model.score_model, ScoreModelDiffuSE) else state_dict_from_jax
    model.score_model.load_state_dict(convert(state.params), strict=True)
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
            "mu": convert(adam.mu), "nu": convert(adam.nu), "count": int(adam.count),
            "acc": convert(multi.acc_grads) if multi is not None else None,
            "mini_step": int(multi.mini_step) if multi is not None else 0,
            "gradient_step": int(multi.gradient_step) if multi is not None else 0,
        },
        "ema": {"params": convert(state.ema.params), "num_updates": int(state.ema.num_updates)},
        "clip": clip,
    })
    return ts
