"""Factor-2 FIR resampling of NHWC tensors with a separable 4-tap filter.

Counterpart of ``diffsep_tpu/ops/pallas/upfirdn.py`` (``_down_kernel``,
``_up_kernel``). ``fir_down2x``/``fir_up2x`` launch the hand-written CUDA
kernels of ``csrc/fir_resample2x.cu`` for a CUDA tensor and take the plain
versions, the general ``upfirdn2d``, for a CPU tensor.

``taps`` are the 4 taps f of one axis, gain included; the 2-D filter is
outer(f, f):
  * fir_down2x == upfirdn2d(x, outer(f, f), down=2, pad=(1, 1))
  * fir_up2x   == upfirdn2d(x, outer(f, f), up=2, pad=(2, 1))

Which kernel runs is a pure function of the shape, ``plan_fir2x``:

- "tma": bf16 with C % 64 == 0 and at least TMA_MIN_VECTORS 16-byte
  vectors of work (the levels from 64 x 80 up). A block owns 8 columns x 64
  channels and a strip of rows; TMA brings the input rows into a ring of
  shared-memory stages, zero-filled past the image (the FIR padding).
- "stream": the other shapes whose rows are whole 16-byte vectors (bf16
  C % 8 == 0, f32 C % 4 == 0). A thread owns one column x 16 bytes of
  channels and walks a strip of rows, its loads running a row ahead.
- "direct": C not a multiple of the vector (C = 6, 3) or an input not
  16-byte aligned: the "stream" kernel one channel wide.

A strip is ``rows`` steps: output rows for down, input rows (two output
rows each) for up. Every call counts as one launch of ``fir_down2x`` or
``fir_up2x``.

Gradients. The two are mutually adjoint, and each one's backward launches
the other kernel, as ``_pallas_bwd`` (``diffsep_tpu/ops/upfirdn2d.py:157-186``)
routes it: upfirdn2d(g, flip(k), up=down, down=up) with the pads derived
there. For k = 4 that is
  * d fir_up2x(x, f)   = fir_down2x(g, f reversed), pads (1, 1) at every size;
  * d fir_down2x(x, f) = fir_up2x(g, f reversed), pads (2, 1) where H and W
    are even. An odd H or W needs (2, 2) on that axis, which neither kernel
    computes, so that backward raises (NCSN++ pads its frames to a multiple
    of 64 and never trains at such a size).
A backward launch counts as a launch of the kernel it runs, and as a
backward one (``_build.backward_counts``).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from . import _build
from .upfirdn2d import out_size, upfirdn2d

Tensor = torch.Tensor

__all__ = ["FirPlan", "fir_down2x", "fir_up2x", "fir_down2x_plain", "fir_up2x_plain", "plan_fir2x"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"direct": 0, "stream": 1, "tma": 2}
_PADS = {False: (1, 1), True: (2, 1)}

SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232_448  # dynamic shared memory one block may use (227 KB)
THREADS = 256  # a "stream" or "direct" block
TMA_C = 64  # channels of a "tma" block (128 bytes of bf16)
TMA_COLS = 8  # columns of a "tma" block, 8 threads each
TMA_STAGES = 4
TMA_MIN_VECTORS = 1 << 15  # bf16 vectors of work below which "stream" is faster
MIN_THREADS = SMS * 256  # "stream"/"direct" strips are cut until this many threads run
MIN_BLOCKS = 4 * SMS  # "tma" strips are cut until this many blocks run


@dataclass(frozen=True)
class FirPlan:
    """How one FIR call runs: kernel variant, channels per thread access
    (vec), steps per strip (rows), columns of a "tma" block (cols; 1, a
    thread's, otherwise), ring stages, threads per block, dynamic shared
    memory and grid."""

    variant: str
    vec: int
    rows: int
    cols: int
    stages: int
    threads: int
    smem_bytes: int
    grid: Tuple[int, int, int]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tma_smem_bytes(up: bool, tw: int, stages: int) -> int:
    # mirrors tma_smem_bytes in csrc/fir_resample2x.cu: boxes of 128-byte
    # lines, (tw + 2) x 1 (up) or (2 tw + 2) x 2 (down), an mbarrier each
    box_bytes = (tw + 2 if up else 2 * (2 * tw + 2)) * 128
    return 128 + stages * (box_bytes + 8)


def _stream(variant: str, vec: int, b: int, steps: int, cols: int, c: int, rows: Optional[int] = None) -> FirPlan:
    """A "stream" or "direct" plan: the longest strip (up to 16 steps) that
    still leaves MIN_THREADS threads, or the one given."""
    per_strip = b * cols * (c // vec)
    if rows is None:
        rows = next((r for r in (16, 8, 4, 2) if r <= steps and per_strip * _cdiv(steps, r) >= MIN_THREADS), 1)
    threads = per_strip * _cdiv(steps, rows)
    return FirPlan(variant, vec, rows, 1, 0, THREADS, 0, (max(1, _cdiv(threads, THREADS)), 1, 1))


def _tma(b: int, steps: int, cols: int, c: int, up: bool, tw: int = TMA_COLS,
         rows: Optional[int] = None, stages: int = TMA_STAGES) -> FirPlan:
    """A "tma" plan with tiles of tw columns: the longest strip (up to 32
    steps) that still leaves MIN_BLOCKS blocks, or the one given."""
    per_strip = _cdiv(cols, tw) * b * (c // TMA_C)
    if rows is None:
        rows = next((r for r in (32, 16, 8, 4, 2) if r <= steps and per_strip * _cdiv(steps, r) >= MIN_BLOCKS), 1)
    grid = (_cdiv(cols, tw), _cdiv(steps, rows), b * (c // TMA_C))
    return FirPlan("tma", 8, rows, tw, stages, 8 * tw, tma_smem_bytes(up, tw, stages), grid)


@functools.lru_cache(maxsize=1024)  # a pure function of the shape, asked on every call
def plan_fir2x(b: int, h: int, w: int, c: int, dtype: torch.dtype = torch.bfloat16,
               up: bool = False, aligned: bool = True) -> FirPlan:
    """The plan for x (b, h, w, c) in ``dtype``, resampled up or down;
    ``aligned``: the input's base address is a multiple of 16 bytes.

    The rules follow per-shape timings of every variant at several strips
    and tiles (scripts/torch_port_fir_plans.py): "tma" beats "stream" by
    5-10% from 2^15 vectors of work up and loses below it, where a call is
    a launch and one memory round trip; both are fastest near 4 waves of
    blocks (tma) or 2^15 threads (stream, direct)."""
    # the rows a strip walks and the columns a thread or tile owns: input
    # ones for up (each feeds a 2 x 2 output quad), output ones for down
    steps, cols = (h, w) if up else (h // 2, w // 2)
    vec = 16 // (4 if dtype == torch.float32 else 2)
    if not aligned or c % vec:
        return _stream("direct", 1, b, steps, cols, c)
    if dtype == torch.bfloat16 and c % TMA_C == 0 and b * steps * cols * c // vec >= TMA_MIN_VECTORS:
        return _tma(b, steps, cols, c, up)
    return _stream("stream", vec, b, steps, cols, c)


def _kernel2d(taps: Sequence[float]) -> np.ndarray:
    f = np.asarray(taps, np.float32)
    return np.outer(f, f)


def fir_down2x_plain(x: Tensor, taps: Sequence[float]) -> Tensor:
    return upfirdn2d(x, _kernel2d(taps), down=2, pad=_PADS[False], data_format="NHWC")


def fir_up2x_plain(x: Tensor, taps: Sequence[float]) -> Tensor:
    return upfirdn2d(x, _kernel2d(taps), up=2, pad=_PADS[True], data_format="NHWC")


class _Args(ctypes.Structure):
    """struct Args of csrc/fir_resample2x.cu, the C entry point's arguments."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "B", "H", "W", "C", "Ho", "Wo", "up", "dtype", "variant", "rows", "cols", "stages", "threads",
        "smem_bytes")] + [("grid", ctypes.c_int * 3), ("ky", ctypes.c_float * 4), ("kx", ctypes.c_float * 4),
                          ("device", ctypes.c_int)]


@functools.lru_cache(maxsize=1024)
def _call(shape: Tuple[int, ...], dtype: torch.dtype, up: bool, taps: Tuple[float, ...], device: int,
          aligned: bool, plan: Optional[FirPlan] = None):
    """The output shape and the C arguments of one call, made once per
    (shape, dtype, direction, taps, device, alignment) for the plan of
    ``plan_fir2x`` or the one given."""
    b, h, w, c = shape
    plan = plan or plan_fir2x(b, h, w, c, dtype, up, aligned)
    factors = (2, 1) if up else (1, 2)
    ho, wo = (out_size(n, *factors, *_PADS[up], 4) for n in (h, w))
    kf = [float(t) for t in taps[::-1]]  # convolution = correlation with flipped taps
    args = _Args(b, h, w, c, ho, wo, int(up), _DTYPES[dtype], _VARIANTS[plan.variant], plan.rows, plan.cols,
                 plan.stages, plan.threads, plan.smem_bytes, (ctypes.c_int * 3)(*plan.grid),
                 (ctypes.c_float * 4)(*kf), (ctypes.c_float * 4)(*kf), device)
    return (b, ho, wo, c), ctypes.pointer(args)


@functools.lru_cache(maxsize=None)
def _entry():
    return _build.entry("fir_resample2x", "fir_resample2x_nhwc",
                        (ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(_Args), ctypes.c_void_p))


def _launch(x: Tensor, taps: Sequence[float], up: bool, plan: Optional[FirPlan] = None,
            backward: bool = False) -> Tensor:
    """Runs ``plan`` (by default ``plan_fir2x``'s) on a CUDA tensor; counted
    as a backward launch where ``backward``."""
    if x.device.type != "cuda":
        raise ValueError(f"fir_resample2x: no kernel for device {x.device}")
    if x.ndim != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(
            f"fir_resample2x: needs a contiguous float32/bfloat16 NHWC tensor, "
            f"got {tuple(x.shape)} {x.dtype}"
        )
    if len(taps) != 4:
        raise ValueError(f"fir_resample2x: needs 4 taps, got {len(taps)}")
    shape, ptr, device = tuple(x.shape), x.data_ptr(), x.device.index
    out_shape, args = _call(shape, x.dtype, up, tuple(taps), device, ptr % 16 == 0, plan)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    name = "fir_up2x" if up else "fir_down2x"
    # the current stream's handle, as torch's own generated kernels take it
    _build.check(_entry()(ptr, out.data_ptr(), args, torch._C._cuda_getCurrentRawStream(device)), name)
    _build.count_launch(name, shape, backward=backward)
    return out


def _resample(x: Tensor, taps: Tuple[float, ...], up: bool, backward: bool = False) -> Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cpu":
        return (fir_up2x_plain if up else fir_down2x_plain)(x, taps)
    return _launch(x, taps, up, backward=backward)


class _Fir2x(torch.autograd.Function):
    """``_resample`` forward; the other direction, taps reversed, backward."""

    @staticmethod
    def forward(ctx, x: Tensor, taps: Tuple[float, ...], up: bool) -> Tensor:
        ctx.taps, ctx.up, ctx.in_shape = taps, up, tuple(x.shape)
        return _resample(x, taps, up)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad: Tensor):
        _, h, w, _ = ctx.in_shape
        if not ctx.up and (h % 2 or w % 2):
            raise NotImplementedError(
                f"fir_down2x backward: no kernel for an odd-sized input {ctx.in_shape} "
                "(its adjoint pads (2, 2) on the odd axis)"
            )
        return _resample(grad.contiguous(), ctx.taps[::-1], not ctx.up, backward=True), None, None


def _fir2x(x: Tensor, taps: Sequence[float], up: bool) -> Tensor:
    taps = tuple(float(t) for t in taps)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Fir2x.apply(x, taps, up)
    return _resample(x, taps, up)


def fir_down2x(x: Tensor, taps: Sequence[float]) -> Tensor:
    """Factor-2 decimation of x (B, H, W, C) -> (B, H // 2, W // 2, C);
    differentiable where grad mode is on, for even H and W."""
    return _fir2x(x, taps, up=False)


def fir_up2x(x: Tensor, taps: Sequence[float]) -> Tensor:
    """Factor-2 interpolation of x (B, H, W, C) -> (B, 2 H, 2 W, C);
    differentiable where grad mode is on."""
    return _fir2x(x, taps, up=True)
