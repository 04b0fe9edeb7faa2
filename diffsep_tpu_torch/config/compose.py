"""Hydra-style YAML config composition (no hydra/omegaconf dependency).

The port's own copy of ``diffsep_tpu/config/compose.py``: hierarchical
groups (datamodule/model/trainer/experiment), `defaults` lists with
`override /group: option` entries, `# @package _global_` overlays,
`${a.b.c}` interpolation, CLI dotted overrides (`model.sde.sigma_min=0.1`,
`experiment=icassp-separation`, `+new.key=1`), and `_target_`-based object
instantiation.

The YAML tree under diffsep_tpu_torch/config/yaml keeps the group names,
option names and keys of the JAX package's tree; its `_target_`s name the
port's classes and its trainer runs on one GPU.
"""
from __future__ import annotations

import importlib
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

import yaml

__all__ = ["compose", "instantiate", "ConfigNode", "load_yaml", "to_dict"]

_INTERP = re.compile(r"\$\{([^}]+)\}")


class ConfigNode(dict):
    """dict with attribute access; nested dicts are ConfigNodes."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k) from None

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict) and not isinstance(obj, ConfigNode):
            return ConfigNode({k: ConfigNode.wrap(v) for k, v in obj.items()})
        if isinstance(obj, ConfigNode):
            return ConfigNode({k: ConfigNode.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [ConfigNode.wrap(v) for v in obj]
        return obj

    def get_path(self, dotted: str, default=None):
        node: Any = self
        for p in dotted.split("."):
            if not isinstance(node, dict) or p not in node:
                return default
            node = node[p]
        return node


def to_dict(node) -> Any:
    if isinstance(node, dict):
        return {k: to_dict(v) for k, v in node.items()}
    if isinstance(node, list):
        return [to_dict(v) for v in node]
    return node


def load_yaml(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _is_global_package(path: Path) -> bool:
    with open(path) as f:
        head = f.readline()
    return "@package" in head and "_global_" in head


def _deep_merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _parse_value(s: str) -> Any:
    return yaml.safe_load(s)


def _set_path(cfg: Dict, dotted: str, value: Any, create: bool = True):
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            if not create:
                raise KeyError(f"Config path not found: {dotted}")
            node[p] = {}
        node = node[p]
    node[parts[-1]] = value


def _resolve_interpolations(cfg: Dict) -> Dict:
    """Resolve ${a.b.c} references against the root config (multi-pass)."""

    def get(dotted: str):
        node: Any = cfg
        for p in dotted.split("."):
            node = node[p]
        return node

    def resolve(obj, depth=0):
        if depth > 20:
            raise ValueError("interpolation depth exceeded (cycle?)")
        if isinstance(obj, dict):
            return {k: resolve(v, depth) for k, v in obj.items()}
        if isinstance(obj, list):
            return [resolve(v, depth) for v in obj]
        if isinstance(obj, str):
            m = _INTERP.fullmatch(obj)
            if m:
                try:
                    return resolve(get(m.group(1)), depth + 1)
                except (KeyError, TypeError):
                    return obj  # unresolvable (e.g. hydra ${now:}) — keep
            def sub(mm):
                try:
                    return str(resolve(get(mm.group(1)), depth + 1))
                except (KeyError, TypeError):
                    return mm.group(0)
            return _INTERP.sub(sub, obj)
        return obj

    prev = None
    cur = cfg
    for _ in range(10):
        cur = resolve(cur)
        if cur == prev:
            break
        prev = cur
    return cur


def compose(
    overrides: Optional[List[str]] = None,
    config_dir: Optional[str | Path] = None,
    config_name: str = "config",
) -> ConfigNode:
    """Compose the config tree exactly like `@hydra.main` would.

    Order: primary config defaults -> group files -> experiment overlay
    (which may `override /group: option`) -> CLI overrides.
    """
    config_dir = Path(config_dir or Path(__file__).parent / "yaml")
    overrides = list(overrides or [])

    primary = load_yaml(config_dir / f"{config_name}.yaml")
    defaults = primary.pop("defaults", ["_self_"])

    # group selections from defaults + CLI group overrides
    selections: Dict[str, Optional[str]] = {}
    order: List[str] = []
    for entry in defaults:
        if entry == "_self_":
            continue
        (group, option), = entry.items()
        selections[group] = option
        order.append(group)

    cli_sets: List[tuple] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Bad override '{ov}' (expected key=value)")
        key, val = ov.split("=", 1)
        additive = key.startswith("+")
        key = key.lstrip("+")
        if key in selections:  # group selection, e.g. experiment=...
            selections[key] = None if val in ("null", "None") else val
        else:
            cli_sets.append((key, _parse_value(val), additive))

    cfg: Dict[str, Any] = dict(primary)

    def apply_group(group: str, option: Optional[str]):
        if option is None:
            return
        path = config_dir / group / f"{option}.yaml"
        data = load_yaml(path)
        data.pop("defaults", None)
        nonlocal cfg
        if _is_global_package(path):
            cfg = _deep_merge(cfg, data)
        else:
            cfg[group] = _deep_merge(cfg.get(group, {}) or {}, data)

    # experiment overlays may re-select other groups via "override /group"
    exp = selections.get("experiment")
    if exp:
        exp_path = config_dir / "experiment" / f"{exp}.yaml"
        exp_defaults = load_yaml(exp_path).get("defaults", [])
        for entry in exp_defaults:
            if entry == "_self_":
                continue
            (g, opt), = entry.items()
            g = g.replace("override ", "").lstrip("/")
            if g in selections:
                selections[g] = opt

    for group in order:
        if group != "experiment":
            apply_group(group, selections.get(group))
    if exp:
        apply_group("experiment", exp)

    for key, val, additive in cli_sets:
        _set_path(cfg, key, val, create=True)

    cfg = _resolve_interpolations(cfg)
    return ConfigNode.wrap(cfg)


def instantiate(node, _recursive_: bool = True, **kwargs):
    """Build the object described by a `_target_` node (hydra semantics,
    as used at pl_model.py:105,110,131)."""
    if not isinstance(node, dict) or "_target_" not in node:
        raise ValueError(f"instantiate() needs a _target_ node, got {node!r}")
    target = node["_target_"]
    mod_name, _, cls_name = target.rpartition(".")
    obj = getattr(importlib.import_module(mod_name), cls_name)
    args = {}
    for k, v in node.items():
        if k in ("_target_", "_recursive_"):
            continue
        if _recursive_ and isinstance(v, dict) and "_target_" in v:
            v = instantiate(v)
        args[k] = v
    args.update(kwargs)
    return obj(**args)
