"""Every hand kernel's wrapper replaced by its plain PyTorch version: a
diagnostic route (the kernels held against their plain versions, a quality
run without the kernels), never the main path."""
from __future__ import annotations

import contextlib
from unittest import mock

from . import conv3x3 as conv_mod
from . import fir_resample2x as fir_mod


@contextlib.contextmanager
def plain_kernels():
    """Within the block, ``conv3x3``, ``fir_down2x`` and ``fir_up2x`` of
    their modules are their ``*_plain`` versions."""
    with contextlib.ExitStack() as stack:
        for mod, name in [(conv_mod, "conv3x3"), (fir_mod, "fir_down2x"), (fir_mod, "fir_up2x")]:
            stack.enter_context(mock.patch.object(mod, name, getattr(mod, name + "_plain")))
        yield
