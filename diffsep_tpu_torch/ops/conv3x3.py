"""3x3 stride-1 SAME convolution on NHWC activations and an HWIO weight.

Counterpart of ``diffsep_tpu/ops/pallas/conv3x3.py``. ``conv3x3`` launches
the hand-written CUDA kernels of ``csrc/conv3x3.cu`` for a CUDA tensor and
takes the plain version ``conv3x3_plain`` for a CPU tensor.

Which kernel runs is a pure function of the shape, ``plan_conv3x3``:

- "tma": bf16, Cin % 64 == 0, Cout % 128 == 0, from 512 output pixels up
  (the large levels and 32 x 40). An implicit GEMM on Hopper's warpgroup
  MMA over patches of 8 x 16 or 16 x 16 output pixels, fed by TMA from a
  producer warpgroup through an mbarrier ring.
- "wgmma": bf16, Cin and Cout multiples of 64, elsewhere. The same products,
  fed by a ring of cp.async stages.
- "tma_narrow" and "narrow": bf16, Cout < 64 (the output convs), an 8-wide
  N tile and the weight resident in shared memory. "tma_narrow" (the large
  levels) brings one TMA box per channel slice and column offset, which
  serves three taps; "narrow" is the "wgmma" loop.
- "generic": float32, any Cin that is not a multiple of 64 (the stem,
  Cin = 6), and operands not aligned to 16 bytes: the first kernel of the
  port (WMMA for bf16, CUDA cores for f32).

Where the output tiles would leave most of the 132 SMs idle (the deep
levels), a "tma", "wgmma" or "narrow" plan splits the K walk over
``splits`` blocks per tile, which write f32 partials to a workspace that a
second, deterministic pass sums.

Every call counts as one ``conv3x3`` launch, whichever of these runs and
whether or not the split-K pass follows.

Gradients. Where an input needs one, ``conv3x3`` is a
``torch.autograd.Function`` whose forward is the kernel and whose backward
is the framework conv's, as ``conv3x3_mxu`` (``conv3x3.py:190-205``) takes
XLA's: dx and dw from ``aten.convolution_backward`` (cuDNN on the card) on
the NHWC tensors viewed as channels-last NCHW, db a sum over (B, H, W).
The backward launches no kernel of ``csrc/`` and counts nothing.

The weight is HWIO (3, 3, Cin, Cout) and contiguous, the layout the kernels
read; ``models.layers.Conv`` keeps the OIHW parameter of the reference
checkpoints and makes this copy once per weight version, not per call.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _build

Tensor = torch.Tensor

__all__ = ["ConvPlan", "conv3x3", "conv3x3_plain", "plan_conv3x3"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"generic": 0, "wgmma": 1, "narrow": 2, "tma": 3, "tma_narrow": 4}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]

SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232_448  # dynamic shared memory one block may use (227 KB)
SLICE = 64  # channels per K slice of the wgmma and narrow kernels
# (variant, bm, bn, stages) instantiated in csrc/conv3x3.cu (CONV3X3_INSTANCES)
INSTANCES = (
    ("wgmma", 128, 128, 4), ("wgmma", 64, 64, 4), ("narrow", 128, 8, 5), ("narrow", 64, 8, 5),
    ("tma", 128, 128, 4), ("tma", 128, 256, 4), ("tma", 256, 128, 4), ("tma_narrow", 256, 8, 4),
)
TMA_W = 16  # output columns of a "tma" patch; it has bm / TMA_W rows
MIN_SLICES = 4  # K slices a split walks at the least, where it can


@dataclass(frozen=True)
class ConvPlan:
    """How one conv3x3 call runs: kernel variant, block tile (bm output
    pixels x bn output channels), ring stages, and K splits (grid z)."""

    variant: str
    bm: int
    bn: int
    stages: int
    splits: int
    grid: Tuple[int, int, int]
    smem_bytes: int  # dynamic shared memory per block (0: the generic kernel's static tiles)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _smem_bytes(variant: str, bm: int, bn: int, stages: int, max_slices: int) -> int:
    # mirrors wgmma_smem_bytes, tma_smem_bytes and tma_narrow_smem_bytes in
    # csrc/conv3x3.cu; max_slices: the K slices of weight a narrow block holds
    if variant == "tma_narrow":  # boxes of (bm / TMA_W + 2) x TMA_W pixels
        return 1024 + stages * (bm + 2 * TMA_W) * 128 + max_slices * 1024 + stages * 16
    ring = stages * bm * 128
    if variant == "narrow":
        return 1024 + ring + max_slices * 1024
    return 1024 + ring + stages * bn * 128 + (stages * 16 if variant == "tma" else 0)


def _make(variant: str, m: int, cout: int, k_tiles: int, bm: int, bn: int, stages: int) -> ConvPlan:
    tiles = -(-m // bm) * -(-cout // bn)
    # Split K where the tiles leave SMs idle: as many splits as keep the
    # blocks within one wave (two for the narrow kernel, whose blocks are
    # short), each walking MIN_SLICES slices or more.
    waves = 2 if variant == "narrow" else 1
    splits = max(1, min(waves * SMS // tiles, k_tiles // MIN_SLICES))
    smem = _smem_bytes(variant, bm, bn, stages, -(-k_tiles // splits))
    while smem > SMEM_LIMIT and splits < k_tiles:  # a narrow kernel's resident weight
        splits += 1
        smem = _smem_bytes(variant, bm, bn, stages, -(-k_tiles // splits))
    return ConvPlan(variant, bm, bn, stages, splits, (-(-m // bm), -(-cout // bn), splits), smem)


def _generic(m: int, cout: int) -> ConvPlan:
    return ConvPlan("generic", 64, 64, 1, 1, (-(-m // 64), -(-cout // 64), 1), 0)


def _patches(b: int, h: int, w: int, bm: int) -> int:
    """The "tma" patches of bm / TMA_W x TMA_W output pixels that cover the images."""
    return b * -(-h // (bm // TMA_W)) * -(-w // TMA_W)


def _tma(b: int, h: int, w: int, cout: int, k_tiles: int, bm: int, bn: int) -> ConvPlan:
    tiles = _patches(b, h, w, bm) * (cout // bn)
    splits = max(1, min(SMS // tiles, k_tiles // MIN_SLICES))  # as in _make
    grid = (_patches(b, h, w, bm), cout // bn, splits)
    return ConvPlan("tma", bm, bn, 4, splits, grid, _smem_bytes("tma", bm, bn, 4, 0))


def _tma_narrow(b: int, h: int, w: int, cout: int, k_tiles: int) -> ConvPlan:
    grid = (min(_patches(b, h, w, 256), SMS), -(-cout // 8), 1)  # a block walks patches
    return ConvPlan("tma_narrow", 256, 8, 4, 1, grid, _smem_bytes("tma_narrow", 256, 8, 4, k_tiles))


@functools.lru_cache(maxsize=1024)  # a pure function of the shape, asked on every call
def plan_conv3x3(b: int, h: int, w: int, cin: int, cout: int,
                 dtype: torch.dtype = torch.bfloat16) -> ConvPlan:
    """The plan for x (b, h, w, cin) -> cout in ``dtype``.

    Large tiles move fewer bytes per product, so the widest tile is taken
    that wastes few rows and still fills the card. From 512 output pixels
    up, the "tma" kernel runs patches of output pixels: 128 x 256 where
    those tiles fill half the card or more, else 256 x 128 where those fill
    it twice or more, else 128 x 128. It is passed over where its patches
    would cover a quarter more pixels than the images have, for the "wgmma"
    kernel's 128 x 128; below 512 pixels "wgmma" takes 64 x 64 (the deepest
    levels). Either splits K where the tiles alone leave SMs idle
    (``_make``). Cout < 64 goes to "tma_narrow" on the
    same terms (16 x 16 patches filling half the card, its weight fitting
    in shared memory), else to "narrow": 128 rows where they fill half the
    card, else 64. These rules follow per-shape timings of every instance
    at several split counts (scripts/torch_port_conv_plans.py)."""
    m = b * h * w
    if dtype != torch.bfloat16 or cin % SLICE or (cout >= 64 and cout % 64):
        return _generic(m, cout)
    k_tiles = 9 * cin // SLICE
    row_tiles = -(-m // 128)

    def fits(bm):
        return 4 * _patches(b, h, w, bm) * bm <= 5 * m

    if cout < 64:
        narrow = _tma_narrow(b, h, w, cout, k_tiles)
        if fits(256) and _patches(b, h, w, 256) >= SMS // 2 and narrow.smem_bytes <= SMEM_LIMIT:
            return narrow
        bm = 128 if row_tiles * -(-cout // 8) >= SMS // 2 else 64
        return _make("narrow", m, cout, k_tiles, bm, 8, 5)
    if cout % 128 or m < 512:
        return _make("wgmma", m, cout, k_tiles, 64, 64, 4)

    if fits(128) and cout % 256 == 0 and row_tiles * (cout // 256) >= SMS // 2:
        return _tma(b, h, w, cout, k_tiles, 128, 256)
    if fits(256) and _patches(b, h, w, 256) * (cout // 128) >= 2 * SMS:
        return _tma(b, h, w, cout, k_tiles, 256, 128)
    if fits(128):
        return _tma(b, h, w, cout, k_tiles, 128, 128)
    return _make("wgmma", m, cout, k_tiles, 128, 128, 4)


def conv3x3_plain(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None) -> Tensor:
    """Plain version: ``F.conv2d`` on NCHW-permuted tensors."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.permute(3, 2, 0, 1), bias, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def _check(x: Tensor, weight: Tensor, bias: Optional[Tensor]) -> None:
    if x.ndim != 4 or weight.shape[:3] != (3, 3, x.shape[-1]) or weight.ndim != 4:
        raise ValueError(f"conv3x3: x {tuple(x.shape)} and weight {tuple(weight.shape)}")
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise TypeError(f"conv3x3: dtypes {x.dtype}, {weight.dtype}")
    tensors = [x, weight] + ([bias] if bias is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("conv3x3: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("conv3x3: tensors must be contiguous")
    if bias is not None and (bias.shape != (weight.shape[3],) or bias.dtype != x.dtype):
        raise ValueError(f"conv3x3: bias {tuple(bias.shape)} {bias.dtype}")


def _launch(x: Tensor, weight: Tensor, bias: Optional[Tensor], plan: ConvPlan) -> Tensor:
    """Runs ``plan`` on CUDA tensors that ``_check`` accepted."""
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    partial = None
    if plan.splits > 1:
        partial = torch.empty((plan.splits, b * h * w, cout), dtype=torch.float32, device=x.device)
    fn = _build.entry("conv3x3", "conv3x3_nhwc", _ARGTYPES)
    err = fn(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(), partial.data_ptr() if partial is not None else None,
        b, h, w, cin, cout, _DTYPES[x.dtype], _VARIANTS[plan.variant], plan.bm, plan.bn,
        plan.stages, plan.splits, x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "conv3x3")
    _build.count_launch("conv3x3", x.shape, cout)
    return out


def _forward(x: Tensor, weight: Tensor, bias: Optional[Tensor]) -> Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: no kernel for device {x.device}")
    _check(x, weight, bias)
    b, h, w, _ = x.shape
    if (x.data_ptr() | weight.data_ptr()) % 16:  # the others copy 16-byte rows
        plan = _generic(b * h * w, weight.shape[3])
    else:
        plan = plan_conv3x3(*x.shape, weight.shape[3], x.dtype)
    return _launch(x, weight, bias, plan)


class _Conv3x3(torch.autograd.Function):
    """The forward of ``_forward``; the framework conv's backward."""

    @staticmethod
    def forward(ctx, x: Tensor, weight: Tensor, bias: Optional[Tensor]) -> Tensor:
        ctx.save_for_backward(x, weight)
        return _forward(x, weight, bias)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad: Tensor):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        grad = grad.contiguous()
        dx = dw = db = None
        if need_x or need_w:
            # the weight as OHWI data, which is OIHW in channels_last
            w_oihw = weight.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
            dx, dw, _ = torch.ops.aten.convolution_backward(
                grad.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w_oihw, None,
                [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [need_x, need_w, False],
            )
            dx = dx.permute(0, 2, 3, 1) if need_x else None
            dw = dw.permute(2, 3, 1, 0) if need_w else None
        if need_b:
            db = grad.sum(dim=(0, 1, 2))
        return dx, dw, db


def conv3x3(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None) -> Tensor:
    """y = conv(x, weight) + bias. x (B, H, W, Cin), weight (3, 3, Cin,
    Cout), bias (Cout,) or None; float32 or bfloat16, accumulated in f32.
    Differentiable in all three where grad mode is on."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, weight, bias)):
        return _Conv3x3.apply(x, weight, bias)
    return _forward(x, weight, bias)
