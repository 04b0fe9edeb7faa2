"""Objects and calls named by dotted import paths.

Counterpart of ``diffsep_tpu/utils/import_module.py`` (pure Python, kept as
its own copy): ``import_name``, ``module_from_config`` and
``run_configured_func``, an object-from-config facility independent of the
config system.
"""
from __future__ import annotations

import importlib
from typing import Any, Mapping


def import_name(dotted: str) -> Any:
    """Import ``pkg.mod.attr`` and return the attribute."""
    mod_name, _, attr = dotted.rpartition(".")
    if not mod_name:
        raise ImportError(f"'{dotted}' is not a dotted import path")
    return getattr(importlib.import_module(mod_name), attr)


def module_from_config(name: str, *args, **kwargs) -> Any:
    """Instantiate ``name`` (a dotted class path) with the given arguments."""
    return import_name(name)(*args, **kwargs)


def run_configured_func(config: Mapping[str, Any], *args, **extra) -> Any:
    """Call the callable described by {'name': <dotted>, 'args': [...],
    'kwargs': {...}}, with extra positional and keyword arguments after
    them."""
    fn = import_name(config["name"])
    call_args = list(config.get("args", [])) + list(args)
    call_kwargs = {**config.get("kwargs", {}), **extra}
    return fn(*call_args, **call_kwargs)
