"""PyTorch + CUDA port of diffsep_tpu: diffusion-based source separation.

The package mirrors ``diffsep_tpu/`` module by module, so each file here has
a counterpart of the same path there. It runs on an NVIDIA Hopper GPU: the
3x3 convolutions and the FIR 2x resampling of NCSN++ are hand-written CUDA
kernels (``csrc/``), built with ``nvcc`` at first use. On the CPU every
kernel is replaced by its plain PyTorch version, which is what the tests use.

Activations of the score network are NHWC (batch, freq, frames, channels),
as in the JAX package.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Asking for CUDA where there is none raises; nothing falls back
    to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
