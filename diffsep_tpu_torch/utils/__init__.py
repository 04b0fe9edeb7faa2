"""Utilities of the port, with the names of ``diffsep_tpu.utils``.

``FixedClipper``, ``AutoClipper`` and ``grad_norm`` live with the trainer
(``train/clippers.py``) and are resolved here lazily, since the trainer's
modules import from this package.
"""
from .distributed import initialize_distributed, is_rank_zero
from .import_module import import_name, module_from_config, run_configured_func
from .linalg import solve_psd_loaded
from .processing_pool import ProcessingPool, SyncProcessingPool
from .registry import Registry
from .split_dir import SplitDirectory
from .stats import ScalerState, StandardScaler


def __getattr__(name):
    if name in ("AutoClipper", "FixedClipper", "grad_norm"):
        from ..train import clippers

        return getattr(clippers, name)
    raise AttributeError(name)


__all__ = [
    "Registry",
    "is_rank_zero",
    "initialize_distributed",
    "import_name",
    "module_from_config",
    "run_configured_func",
    "solve_psd_loaded",
    "ProcessingPool",
    "SyncProcessingPool",
    "SplitDirectory",
    "StandardScaler",
    "ScalerState",
    "FixedClipper",
    "AutoClipper",
    "grad_norm",
]
