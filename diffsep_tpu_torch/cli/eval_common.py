"""Flag helpers shared by the inference CLIs.

Counterpart of ``str2bool``, ``sampler_flag_map`` and ``reject_baked_flags``
in ``diffsep_tpu/cli/eval_common.py``; the rest of that module comes with
evaluation.
"""
from __future__ import annotations


def str2bool(v):
    """argparse-friendly boolean (``type=bool`` takes 'False' as True):
    true/false/1/0/yes/no in any case."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("1", "true", "t", "yes", "y"):
        return True
    if v.lower() in ("0", "false", "f", "no", "n"):
        return False
    raise ValueError(f"expected a boolean, got {v!r}")


def sampler_flag_map(args) -> dict:
    """The sampler flags a CLI's parsed ``args`` has, by flag name (None =
    not set by the user)."""
    return {flag: getattr(args, attr) for attr, flag in (
        ("N", "-N"), ("snr", "--snr"), ("corrector_steps", "--corrector-steps"),
        ("predictor", "--predictor"), ("corrector", "--corrector"),
        ("schedule", "--schedule"), ("denoise", "--denoise"),
    ) if hasattr(args, attr)}


def reject_baked_flags(set_map: dict, why: str) -> None:
    """SystemExit naming every flag of ``set_map`` that is set, where the
    sampler is fixed and cannot take them."""
    set_flags = [k for k, v in set_map.items() if v is not None]
    if set_flags:
        raise SystemExit(f"{', '.join(set_flags)}: {why}")
