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
- "tf32x3": float32, Cin % 32 == 0 and Cout % 64 == 0 (every trunk conv),
  or Cout < 64 (the output convs, on an 8-wide N tile). The "wgmma" loop
  over 32-channel slices on the tensor cores in TF32 with split operands
  (hi + lo, three products), which keeps float32 accuracy.
  It reads the weight K-major and split: ``tf32_split_weight`` makes that
  copy with a kernel of its own, once per weight version where no gradient
  is recorded (``_split_weight``), else on every call.
- "slice32": bf16, Cin % 32 == 0 and Cin % 64 != 0 (32, 96, 160, ...:
  the learning demos' nf 32 NCSN++), Cout a multiple of 32, or < 64. It
  replaces the same Pallas kernels (``_conv_kernel``,
  ``_conv_kernel_im2col``) at these channel counts, where bytes bound the
  conv (~144 FLOP per byte at Cin = Cout = 32). The weight's block of
  Cout (an N tile of 32 or 8 channels) stays in shared memory; one block
  per SM walks patches of 8 x 16 or 16 x 16 output pixels, K as (tap,
  32-channel slice) in the 64-byte swizzle, fed by TMA through an
  mbarrier ring per consumer warpgroup, the two warpgroups taking whole
  patches in turn; one box per (slice, column offset) serves three taps
  as wgmma operands in shared memory; bias and one rounding in registers,
  the output tile staged in shared memory and written by a TMA store.
- "generic": the other float32 calls (Cin = 6, other channel counts),
  bf16 with Cin not a multiple of 32 (the stem, Cin = 6; 40) or Cout >= 64
  off the N tiles (not a multiple of 64, or of 32 at Cin % 64 == 32), and
  operands not aligned to 16 bytes: the first kernel of the port (WMMA for
  bf16, CUDA cores for f32).

Where the output tiles would leave most of the 132 SMs idle (the deep
levels), a "tma", "wgmma", "narrow" or "tf32x3" plan splits the K walk over
``splits`` blocks per tile, which write f32 partials to a workspace that a
second, deterministic pass sums.

Every call counts as one ``conv3x3`` launch, whichever of these runs and
whether or not the split-K pass or the weight's split pass runs with it.

The op. ``conv3x3`` calls the custom op ``torch.ops.diffsep.conv3x3``
(``torch.library``): its CPU implementation is the plain version, its
CUDA one the kernel, which raises where it cannot launch; a fake
implementation gives the output's shape, so ``torch.export`` traces each
call as one node and the exported program launches the kernel, counted as
here. The alignment test that picks the generic kernel reads data
pointers, so it lives in the real implementation only.

Gradients. The op's autograd (``torch.library.register_autograd``) takes
the route of the input's type:

- float32 on the card: hand kernels, where ``conv3x3_mxu``
  (``diffsep_tpu/ops/pallas/conv3x3.py:190-208``) takes XLA's VJP. dx is
  the forward conv of dy with the weight flipped and transposed,
  w'[kh, kw, co, ci] = w[2 - kh, 2 - kw, ci, co] (exact for a 3 x 3
  stride-1 SAME conv): one ``conv3x3`` call on ``plan_conv3x3_dx``'s plan
  (the forward's plan for Cout -> Cin, a "tf32x3" one split to at most
  DX_MAX_SLICES slices a split for float32 accuracy), "tf32x3" reading w'
  split by the split pass with its flip on every backward call, "generic"
  a flipped HWIO copy; none where x takes no gradient (the stem). dw runs
  ``conv3x3_dw`` (csrc/conv3x3.cu) on ``plan_conv3x3_dw``'s plan: "window"
  where a side has 8 channels or fewer (the stem, the output convs) on the
  CUDA cores, a thread's 3 x 3 window of the other side in registers;
  "tf32x3" (Cin % 32 == 0, Cout % 32 == 0) on ``wgmma`` with split
  operands, the groups of slices chained without a wait between them; else
  "generic" on the CUDA cores; its pixels split over the SMs and the
  partials summed in a fixed order (bitwise deterministic).
- bfloat16 on the card: ``aten.convolution_backward`` (cuDNN) on the NHWC
  tensors viewed as channels-last NCHW: at the recipe's shapes its dx and
  dw take 6.0 + 6.7 ms per micro-step, and the hand bf16 forward run as
  dx 8.6 (H100; ``scripts/torch_port_conv_plans.py --backward --dtype
  bfloat16``).
- the CPU: ``aten.convolution_backward`` as well (the plain route).

db is a sum over (B, H, W). A dx launch counts one ``conv3x3`` launch and a
dw launch one ``conv3x3_dw`` launch, both as backward launches; the
bfloat16 and CPU routes count nothing.

The weight is HWIO (3, 3, Cin, Cout) and contiguous, the layout the kernels
read; ``models.layers.Conv`` keeps the OIHW parameter of the reference
checkpoints and makes this copy once per weight version, not per call.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

Tensor = torch.Tensor

__all__ = ["ConvPlan", "conv3x3", "conv3x3_dw", "conv3x3_dw_plain", "conv3x3_dx", "conv3x3_dx_plain",
           "conv3x3_plain", "plan_conv3x3", "plan_conv3x3_dw", "plan_conv3x3_dx", "tf32_round", "tf32_split_weight",
           "tf32_split_weight_plain", "tf32x3_dw_emulated", "window_dw_emulated"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"generic": 0, "wgmma": 1, "narrow": 2, "tma": 3, "tma_narrow": 4, "tf32x3": 5, "slice32": 6,
             "window": 7}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
_SPLIT_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_DW_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]

SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232_448  # dynamic shared memory one block may use (227 KB)
SLICE = 64  # channels per K slice of the bf16 wgmma and narrow kernels
F32_SLICE = 32  # channels per K slice of the tf32x3 kernel (128-byte rows, as SLICE bf16)
C32 = 32  # channels per K slice of the bf16 slice32 kernel (64-byte rows)
# (variant, bm, bn, stages) instantiated in csrc/conv3x3.cu (CONV3X3_INSTANCES)
INSTANCES = (
    ("wgmma", 128, 128, 4), ("wgmma", 64, 64, 4), ("narrow", 128, 8, 5), ("narrow", 64, 8, 5),
    ("tma", 128, 128, 4), ("tma", 128, 256, 4), ("tma", 256, 128, 4), ("tma_narrow", 256, 8, 4),
    ("tf32x3", 192, 128, 4), ("tf32x3", 128, 128, 4), ("tf32x3", 64, 64, 4),
    ("tf32x3", 64, 8, 4),
    ("slice32", 128, 8, 8), ("slice32", 128, 32, 8), ("slice32", 256, 8, 6), ("slice32", 256, 32, 6),
)
TMA_W = 16  # output columns of a "tma" patch; it has bm / TMA_W rows
MIN_SLICES = 4  # K slices a split walks at the least, where it can
PARTIAL_COST = 3e-4  # tf32x3: a split's partials per output element, in 128-row slices (_tf32x3_cost)
NARROW_WAVES = 4  # tf32x3's 64 x 8 blocks that a split plan keeps per SM
# the weight gradient's (variant, bm, bn) instantiated in csrc/conv3x3.cu
# (conv3x3_dw): "tf32x3" rows of (9 Cin) x Cout columns on a ring of
# DW_STAGES stages, "window"'s 32 wide channels x 2-8 narrow ones, and
# "generic"'s 64 x 64 tile; the blocks of "tf32x3" and "generic" that the
# card holds at once (one "tf32x3" block per SM, by its registers; four of
# "generic"'s at the least); the waves of them a split plan may take; the
# 32-pixel slices a split walks at the least; the blocks a "window" plan
# aims at (two waves of two a SM), and the narrow side it takes at the most
DW_INSTANCES = (("tf32x3", 128, 128), ("tf32x3", 128, 64), ("tf32x3", 128, 32), ("window", 32, 2),
                ("window", 32, 4), ("window", 32, 6), ("window", 32, 8), ("generic", 64, 64))
DW_STAGES = 5
DW_RESIDENT = {"tf32x3": SMS, "generic": 4 * SMS}
DW_WAVES, DW_MIN_SLICES = 2, 8
DW_CHAIN = 4  # "tf32x3" slices whose wgmma chain a thread adds into its f32 sum at once
WINDOW_BLOCKS, WINDOW_NARROW, WINDOW_COLS, WINDOW_CH = 4 * SMS, 8, 8, 32
# the 32-channel slices a "tf32x3" dx split walks at the most: the tensor
# cores' f32 accumulation does not round to nearest, and its error grows
# with the walk (unsplit over the 72 slices of a Cout 256 conv, dx's error
# reached 1.9e-5 of its largest value on an H100); the splits' partials
# are summed in f32, rounded to nearest, by the reduction pass
DX_MAX_SLICES = 36


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
    # mirrors wgmma_smem_bytes, tma_smem_bytes, tma_narrow_smem_bytes,
    # tf32x3_smem_bytes and slice32_smem_bytes in csrc/conv3x3.cu;
    # max_slices: the K slices of weight a narrow or slice32 block holds
    if variant == "tf32x3":  # A, then B's hi and lo halves, per stage
        return 1024 + stages * (bm + 2 * bn) * 128
    if variant == "slice32":  # boxes of (bm / TMA_W + 2) x TMA_W pixels of 64 bytes
        box = (bm // TMA_W + 2) * TMA_W * 64
        staged = 2 * bm * bn * 2 if bn == 32 else 0  # each consumer warpgroup's output tile
        return 1024 + stages * -(-box // 1024) * 1024 + staged + max_slices * bn * 64 + stages * 16
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
    # short, and for tf32x3's 64 x 64 tiles, two of which share an SM), each
    # walking MIN_SLICES slices or more.
    waves = 2 if variant == "narrow" or (variant, bm) == ("tf32x3", 64) else 1
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


def _c32(b: int, h: int, w: int, cin: int, cout: int, bm: int, bn: int) -> Optional[ConvPlan]:
    """The "slice32" plan of bm-row patches and bn-wide N tiles (32 where
    Cout is a multiple of 32, 8 where Cout < 64): one block per SM over the
    Cout tiles, each walking patches; the kernel launches grid[0] blocks
    per tile. None where that instance does not exist or its resident
    weight does not fit."""
    stages = next((st for v, m_, n_, st in INSTANCES if (v, m_, n_) == ("slice32", bm, bn)), None)
    if stages is None or not (cout % bn == 0 if bn > 8 else cout < 64):
        return None
    smem = _smem_bytes("slice32", bm, bn, stages, 9 * cin // C32)
    if smem > SMEM_LIMIT:
        return None
    n_tiles = -(-cout // bn)
    return ConvPlan("slice32", bm, bn, stages, 1,
                    (min(_patches(b, h, w, bm), max(1, SMS // n_tiles)), n_tiles, 1), smem)


def _plan_c32(b: int, h: int, w: int, cin: int, cout: int) -> Optional[ConvPlan]:
    """bf16 with Cin % 32 == 0 and Cin % 64 != 0 (see ``plan_conv3x3``):
    the 32-wide N tile, or the 8-wide one where Cout < 64 and either Cout
    is off 32 or the wider tile's weight does not fit."""
    if cout % 32 and cout >= 64:
        return None
    bm = 256 if _patches(b, h, w, 256) * -(-cout // 32) >= SMS else 128
    for bn in (32, 8):
        plan = _c32(b, h, w, cin, cout, bm, bn) or _c32(b, h, w, cin, cout, 128, bn)
        if plan is not None:
            return plan
    return None


def _tf32x3(m: int, cout: int, k_tiles: int) -> ConvPlan:
    if cout < 64:
        # the output convs: 64 x 8 tiles, five of whose blocks share an SM;
        # their slices are short, so K splits down to two slices a split
        grid = (-(-m // 64), -(-cout // 8))
        splits = max(1, min(NARROW_WAVES * SMS // (grid[0] * grid[1]), k_tiles // 2))
        return ConvPlan("tf32x3", 64, 8, 4, splits, grid + (splits,), _smem_bytes("tf32x3", 64, 8, 4, 0))
    if cout % 128 or m < 256:
        return _make("tf32x3", m, cout, k_tiles, 64, 64, 4)
    plans = []
    for bm in (128, 192):
        plan = _make("tf32x3", m, cout, k_tiles, bm, 128, 4)
        plans.append(plan)
        if plan.splits == 1 and k_tiles >= 2 * MIN_SLICES:
            plans.append(dataclasses.replace(plan, splits=2, grid=plan.grid[:2] + (2,)))
    return min(plans, key=lambda p: _tf32x3_cost(p, m, cout, k_tiles))


def _tf32x3_cost(plan: ConvPlan, m: int, cout: int, k_tiles: int) -> float:
    """A model of a "tf32x3" plan's time, in units of one 128-row block's K
    slice: the waves of blocks (one block per SM) x the rows and slices
    each block walks, 192-row blocks taking 10% less per row (a quarter
    fewer bytes from L2), plus the split's f32 partials (PARTIAL_COST per
    output element and split). Fitted to the timings of
    scripts/torch_port_conv_plans.py --dtype float32."""
    rows = plan.bm * (0.9 if plan.bm == 192 else 1.0)
    partials = PARTIAL_COST * plan.splits * m * cout if plan.splits > 1 else 0.0
    return -(-plan.blocks // SMS) * rows * -(-k_tiles // plan.splits) + partials


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
    at several split counts (scripts/torch_port_conv_plans.py).

    float32 with Cin % 32 == 0 and Cout % 64 == 0 goes to "tf32x3". Where
    Cout % 128 == 0, from 256 output pixels up, it takes 128 x 128 or 192 x
    128 tiles, split as above or, unsplit plans, also in two, whichever
    ``_tf32x3_cost`` (waves x rows x slices, plus the partials) finds
    cheapest; else 64 x 64 tiles (the deepest levels, split over two
    waves; Cout % 128 == 64). Cout < 64 takes 64 x 8
    tiles, split where they leave fewer than NARROW_WAVES blocks per SM.
    Every other float32 call goes to "generic".

    bf16 with Cin % 32 == 0 and Cin % 64 != 0 goes to "slice32", unsplit.
    Its N tile is 32 channels where Cout % 32 == 0, else 8 (Cout < 64; also
    where the 32-wide tile's resident weight would not fit in shared
    memory); its patches are 16 x 16 where they give every block one or
    more over the 32-wide Cout tiles, else 8 x 16. Cout >= 64 not a multiple
    of 32 goes to "generic". These rules follow per-shape timings of every
    instance at the learning demo's shapes (scripts/torch_port_conv_plans.py
    --shapes demo)."""
    m = b * h * w
    if dtype == torch.float32:
        if cin % F32_SLICE or (cout >= 64 and cout % 64):
            return _generic(m, cout)
        return _tf32x3(m, cout, 9 * cin // F32_SLICE)
    if dtype != torch.bfloat16:
        return _generic(m, cout)
    if cin % SLICE and cin % C32 == 0:
        plan = _plan_c32(b, h, w, cin, cout)
        if plan is not None:
            return plan
    if cin % SLICE or (cout >= 64 and cout % 64):
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


@functools.lru_cache(maxsize=1024)
def plan_conv3x3_dx(b: int, h: int, w: int, cin: int, cout: int) -> ConvPlan:
    """The plan of ``conv3x3_dx`` for the float32 conv x (b, h, w, cin) ->
    cout: the forward's plan for dy (b, h, w, cout) -> cin, a "tf32x3" one
    split further where a split would walk more than DX_MAX_SLICES."""
    plan = plan_conv3x3(b, h, w, cout, cin, torch.float32)
    need = -(-9 * cout // F32_SLICE // DX_MAX_SLICES)
    if plan.variant != "tf32x3" or plan.splits >= need:
        return plan
    return dataclasses.replace(plan, splits=need, grid=plan.grid[:2] + (need,))


def _dw_splits(tiles: int, k_tiles: int, resident: int) -> int:
    """K splits of a weight-gradient plan: the count, up to DW_WAVES waves of
    ``resident`` blocks and down to DW_MIN_SLICES slices a split, whose
    waves times slices per split is least (the fewest splits among equals:
    fewer partials)."""
    most = max(1, min(DW_WAVES * resident // tiles, k_tiles // DW_MIN_SLICES))
    return min(range(1, most + 1), key=lambda s: (-(-tiles * s // resident) * -(-k_tiles // s), s))


def _window(b: int, h: int, w: int, cin: int, cout: int) -> ConvPlan:
    """The "window" plan: blocks of WINDOW_CH wide channels (the side of more
    channels) x WINDOW_COLS columns of one image, over strips of rows: as
    few strips as give WINDOW_BLOCKS blocks, at most one a row. ``bn`` is
    the narrow side's count rounded up to even; ``splits``, the blocks per
    WINDOW_CH wide channels, each writing a partial."""
    chunks, per_strip = -(-max(cin, cout) // WINDOW_CH), b * -(-w // WINDOW_COLS)
    strips = min(h, max(1, -(-WINDOW_BLOCKS // (chunks * per_strip))))
    narrow = min(cin, cout)
    splits = per_strip * strips
    return ConvPlan("window", WINDOW_CH, narrow + narrow % 2, 1, splits, (chunks, 1, splits), 0)


@functools.lru_cache(maxsize=1024)
def plan_conv3x3_dw(b: int, h: int, w: int, cin: int, cout: int, aligned: bool = True) -> ConvPlan:
    """The plan of ``conv3x3_dw`` for float32 x (b, h, w, cin) and dy (b, h,
    w, cout): a GEMM of 9 cin rows x cout columns over b h w pixels.
    "window" where one side has WINDOW_NARROW channels or fewer (the stem,
    the output convs; ``_window``). Else "tf32x3" where Cin % 32 == 0 and
    Cout % 32 == 0, on 128-row tiles 128, 64 or 32 columns wide (the widest
    that divides Cout), walked in chains of DW_CHAIN 32-pixel slices; else
    "generic" on 64 x 64 tiles, walked in 32-pixel slices. Their pixels
    split over ``_dw_splits``, within DW_WAVES waves of the blocks the card
    holds at once (DW_RESIDENT); their partials (splits, 9 cin, cout)
    therefore take at most DW_WAVES x DW_RESIDENT x bm x bn floats. Not
    ``aligned`` (x off 16 bytes): "generic" for "tf32x3"."""
    if min(cin, cout) <= WINDOW_NARROW:
        return _window(b, h, w, cin, cout)
    rows, k_tiles = 9 * cin, -(-b * h * w // F32_SLICE)
    if cin % F32_SLICE == 0 and cout % 32 == 0 and aligned:
        variant, bm, bn = "tf32x3", 128, next(n for n in (128, 64, 32) if cout % n == 0)
        smem = 1024 + DW_STAGES * 2 * bn * 128  # dw_tf32x3_smem_bytes in csrc/conv3x3.cu
        k_tiles = DW_CHAIN * -(-b * h * w // (DW_CHAIN * F32_SLICE))  # it walks whole chains of slices
    else:
        variant, bm, bn, smem = "generic", 64, 64, 0
    grid = (-(-rows // bm), -(-cout // bn))
    splits = _dw_splits(grid[0] * grid[1], k_tiles, DW_RESIDENT[variant])
    return ConvPlan(variant, bm, bn, DW_STAGES if variant == "tf32x3" else 1, splits, grid + (splits,), smem)


def conv3x3_plain(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None) -> Tensor:
    """Plain version: ``F.conv2d`` on NCHW-permuted tensors."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.permute(3, 2, 0, 1), bias, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def conv3x3_dx_weight(weight: Tensor) -> Tensor:
    """The weight of dx as a conv of dy: w'[kh, kw, co, ci] = w[2 - kh, 2 -
    kw, ci, co], HWIO (3, 3, Cout, Cin), contiguous."""
    return weight.flip((0, 1)).transpose(2, 3).contiguous()


def conv3x3_dx_plain(dy: Tensor, weight: Tensor) -> Tensor:
    """Plain version of ``conv3x3_dx``: ``conv3x3_plain`` of dy with w'."""
    return conv3x3_plain(dy, conv3x3_dx_weight(weight))


def _shifted(x: Tensor):
    """The nine views of the zero-padded x (B, H, W, C) that tap (kh, kw)
    reads for each output pixel, in HWIO tap order."""
    h, w = x.shape[1:3]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return [xp[:, kh:kh + h, kw:kw + w] for kh in range(3) for kw in range(3)]


def conv3x3_dw_plain(x: Tensor, dy: Tensor) -> Tensor:
    """Plain version of ``conv3x3_dw``: dw (3, 3, Cin, Cout), a sum over the
    pixels of each of the nine shifted views of padded x times dy."""
    cin, cout = x.shape[3], dy.shape[3]
    return torch.stack([torch.einsum("bhwc,bhwo->co", v, dy) for v in _shifted(x)]).reshape(3, 3, cin, cout)


def tf32_round(v: Tensor) -> Tensor:
    """float32 -> tf32 as ``cvt.rna.tf32.f32`` rounds: to 10 mantissa bits,
    ties away from zero, the 13 low bits zero (still stored as float32)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split_rows_plain(mat: Tensor, k: int) -> Tensor:
    """A row-major (rows, N) float32 operand as the "tf32x3" kernels read it
    from global memory, (2, N, k): hi = tf32(v), then lo = tf32(v - hi),
    K-major, rows past ``rows`` (up to k, a multiple of 32) zero, where
    column 8 kk + c of each 32-row slice holds row 8 (c % 4) + 2 kk + c // 4
    of the slice (the K index a thread's tf32 register fragments take; see
    csrc/conv3x3.cu)."""
    n = mat.shape[1]
    col = torch.arange(F32_SLICE, device=mat.device)
    src = 8 * (col % 8 % 4) + 2 * (col // 8) + col % 8 // 4
    padded = F.pad(mat, (0, 0, 0, k - mat.shape[0]))
    wt = padded.reshape(k // F32_SLICE, F32_SLICE, n)[:, src].permute(2, 0, 1).reshape(n, k)
    hi = tf32_round(wt)
    return torch.stack([hi, tf32_round(wt - hi)])


def tf32_split_weight_plain(weight: Tensor) -> Tensor:
    """Plain version of ``tf32_split_weight``: the float32 HWIO weight (3, 3,
    Cin, Cout) seen as (9 Cin, Cout), split as ``tf32_split_rows_plain``
    lays it out: (2, Cout, 9 Cin)."""
    cin, cout = weight.shape[2], weight.shape[3]
    return tf32_split_rows_plain(weight.reshape(9 * cin, cout), 9 * cin)


def tf32_split_weight(weight: Tensor, flip: bool = False) -> Tensor:
    """The split weight of ``tf32_split_weight_plain``, made on the card by
    the kernel conv3x3_tf32_split_weight (csrc/conv3x3.cu) for a CUDA
    tensor; the plain version for a CPU one. With ``flip``, the split of
    dx's weight ``conv3x3_dx_weight(weight)``, which the same kernel reads
    from ``weight`` itself. Part of a conv3x3 call: it counts no launch of
    its own."""
    if weight.device.type == "cpu":
        return tf32_split_weight_plain(conv3x3_dx_weight(weight) if flip else weight)
    cin, cout = weight.shape[2], weight.shape[3]
    k_ch, n = (cout, cin) if flip else (cin, cout)
    if weight.dtype != torch.float32 or not weight.is_contiguous() or k_ch % F32_SLICE:
        raise ValueError(f"tf32_split_weight: weight {tuple(weight.shape)} {weight.dtype}, flip {flip}")
    split = torch.empty((2, n, 9 * k_ch), dtype=torch.float32, device=weight.device)
    fn = _build.entry("conv3x3", "conv3x3_tf32_split", _SPLIT_ARGTYPES)
    err = fn(weight.data_ptr(), split.data_ptr(), cin, cout, int(flip), weight.device.index,
             torch.cuda.current_stream(weight.device).cuda_stream)
    _build.check(err, "conv3x3_tf32_split")
    return split


def tf32x3_dw_emulated(x: Tensor, dy: Tensor, splits: Optional[int] = None) -> Tensor:
    """The "tf32x3" weight gradient's arithmetic in float64: each of x's
    shifted views and dy split into hi = tf32(v) and lo = tf32(v - hi),
    and hi.hi + hi.lo + lo.hi summed exactly (the kernel sums in f32).
    With ``splits``, the kernel's order of summation instead: the pixels in
    chains of DW_CHAIN 32-pixel slices split into ``splits`` walks; each
    chain's products summed exactly and rounded once to float32 (the wgmma
    chain's sum, whose own rounding this leaves out), the chains of a walk
    added in turn into a float32 sum, and the walks' partials added in
    order in float32 (conv3x3_dw_splitk_reduce)."""
    cin, cout = x.shape[3], dy.shape[3]

    def split(v):
        v = v.reshape(-1, v.shape[-1])
        hi = tf32_round(v)
        return hi.double(), tf32_round(v - hi).double()

    b_hi, b_lo = split(dy)
    if splits is None:
        taps = []
        for view in _shifted(x):
            a_hi, a_lo = split(view)
            taps.append(a_hi.T @ b_hi + a_hi.T @ b_lo + a_lo.T @ b_hi)
        return torch.stack(taps).reshape(3, 3, cin, cout)
    chains = -(-b_hi.shape[0] // (DW_CHAIN * F32_SLICE))
    k_tiles = DW_CHAIN * chains

    def slices(v):  # (k_tiles, 32, C), zero past the last pixel
        return F.pad(v, (0, 0, 0, k_tiles * F32_SLICE - v.shape[0])).reshape(k_tiles, F32_SLICE, -1)

    b_hi, b_lo = slices(b_hi), slices(b_lo)
    prods = torch.stack([torch.einsum("spc,spo->sco", a_hi, b_hi + b_lo) + torch.einsum("spc,spo->sco", a_lo, b_hi)
                         for a_hi, a_lo in ((slices(a) for a in split(view)) for view in _shifted(x))], 1)
    out = torch.zeros((9, cin, cout), dtype=torch.float32, device=x.device)
    for z in range(splits):
        first, end = DW_CHAIN * (z * chains // splits), DW_CHAIN * ((z + 1) * chains // splits)
        walk = torch.zeros_like(out)
        for i in range(first, end, DW_CHAIN):
            walk = walk + prods[i:min(i + DW_CHAIN, end)].sum(0).float()
        out = out + walk
    return out.reshape(3, 3, cin, cout)


def window_dw_emulated(x: Tensor, dy: Tensor, strips: int, dtype: torch.dtype = torch.float64) -> Tensor:
    """The "window" weight gradient's arithmetic in ``dtype``, in the
    kernel's layout and order (csrc/conv3x3.cu, conv3x3_dw_window_kernel):
    the wide side (x, or dy where Cin < Cout) read through a 3 x 3 window
    that walks down each column over ``strips`` strips of rows, times the
    narrow side at the pixel, added row by row; a block's WINDOW_COLS
    columns summed in order, then the blocks' partials in blockIdx.y order
    (image, strip, column group); window position (a, b) is tap (a, b), or
    (2 - a, 2 - b) where the sides are swapped."""
    b, h, w, cin = x.shape
    cout = dy.shape[3]
    flip = cin < cout
    wide, narrow = (dy, x) if flip else (x, dy)
    cw, cn = wide.shape[3], narrow.shape[3]
    groups = -(-w // WINDOW_COLS)
    cols = groups * WINDOW_COLS
    wp = F.pad(wide.to(dtype), (0, 0, 1, 1 + cols - w, 1, 1))  # the window's halo, zero
    nar = F.pad(narrow.to(dtype), (0, 0, 0, cols - w))
    acc = torch.zeros((b, strips, cols, 9, cw, cn), dtype=dtype, device=x.device)
    for s in range(strips):
        for row in range(s * h // strips, (s + 1) * h // strips):
            win = torch.stack([wp[:, row + a, bb:bb + cols] for a in range(3) for bb in range(3)], 2)
            acc[:, s] += win[..., None] * nar[:, row, :, None, None, :]
    acc = acc.reshape(b * strips * groups, WINDOW_COLS, 9, cw, cn)
    blocks = acc[:, 0]
    for col in range(1, WINDOW_COLS):
        blocks = blocks + acc[:, col]
    out = torch.zeros_like(blocks[0])
    for part in blocks:
        out = out + part
    if flip:  # (pos, co, ci) -> taps reversed, (ci, co)
        return out.flip(0).permute(0, 2, 1).reshape(3, 3, cin, cout)
    return out.reshape(3, 3, cin, cout)


# id(weight) -> (a weak reference to it, its version, its split weight)
_split_cache: dict = {}


def _split_weight(weight: Tensor) -> Tensor:
    """``tf32_split_weight(weight)``, kept per weight tensor and version
    where no gradient is recorded (serving: ``models.layers.Conv`` keeps its
    HWIO copy per weight version, so each is split once); in grad mode, made
    on every call, as the HWIO copy is."""
    key = id(weight)
    hit = _split_cache.get(key)
    if hit is not None and hit[0]() is weight and hit[1] == weight._version:
        return hit[2]
    split = tf32_split_weight(weight)
    if not torch.is_grad_enabled():
        ref = weakref.ref(weight, lambda _, key=key: _split_cache.pop(key, None))
        _split_cache[key] = (ref, weight._version, split)
    return split


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
    return _run(x, _split_weight(weight) if plan.variant == "tf32x3" else weight, weight.shape[3], bias, plan)


def _run(x: Tensor, operand: Tensor, cout: int, bias: Optional[Tensor], plan: ConvPlan,
         backward: bool = False) -> Tensor:
    """Runs ``plan`` on x and ``operand``, the weight as the plan's kernel
    reads it (split for "tf32x3"), to ``cout`` channels."""
    b, h, w, cin = x.shape
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    partial = None
    if plan.splits > 1:
        partial = torch.empty((plan.splits, b * h * w, cout), dtype=torch.float32, device=x.device)
    fn = _build.entry("conv3x3", "conv3x3_nhwc", _ARGTYPES)
    err = fn(
        x.data_ptr(), operand.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(), partial.data_ptr() if partial is not None else None,
        b, h, w, cin, cout, _DTYPES[x.dtype], _VARIANTS[plan.variant], plan.bm, plan.bn,
        plan.stages, plan.splits, plan.grid[0], x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "conv3x3")
    _build.count_launch("conv3x3", x.shape, cout, backward=backward, plan=plan.variant)
    return out


def _aligned(*tensors: Tensor) -> bool:
    """Whether every data pointer is 16-byte aligned, as the kernels that
    copy 16-byte rows need; the generic kernels take any."""
    return not any(t.data_ptr() % 16 for t in tensors)


def _forward(x: Tensor, weight: Tensor, bias: Optional[Tensor]) -> Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: no kernel for device {x.device}")
    _check(x, weight, bias)
    b, h, w, _ = x.shape
    cout = weight.shape[3]
    plan = plan_conv3x3(*x.shape, cout, x.dtype) if _aligned(x, weight) else _generic(b * h * w, cout)
    return _launch(x, weight, bias, plan)


def conv3x3_dx(dy: Tensor, weight: Tensor) -> Tensor:
    """dx (B, H, W, Cin) of y = conv3x3(x, weight) from dy (B, H, W, Cout),
    float32: on the card one ``conv3x3`` launch (counted as a backward
    launch) of dy with the flipped, transposed weight, planned as a conv
    of Cout -> Cin channels; ``conv3x3_dx_plain`` on the CPU."""
    if dy.device.type == "cpu":
        return conv3x3_dx_plain(dy, weight)
    cin = weight.shape[2]
    if dy.ndim != 4 or weight.shape != (3, 3, cin, dy.shape[3]) or {dy.dtype, weight.dtype} != {torch.float32} \
            or weight.device != dy.device or not (dy.is_contiguous() and weight.is_contiguous()):
        raise ValueError(f"conv3x3_dx: dy {tuple(dy.shape)} {dy.dtype}, weight {tuple(weight.shape)} {weight.dtype}")
    b, h, w, cout = dy.shape
    plan = plan_conv3x3_dx(b, h, w, cin, cout) if _aligned(dy) else _generic(b * h * w, cin)
    operand = tf32_split_weight(weight, flip=True) if plan.variant == "tf32x3" else conv3x3_dx_weight(weight)
    return _run(dy, operand, cin, None, plan, backward=True)


def conv3x3_dw(x: Tensor, dy: Tensor) -> Tensor:
    """dw (3, 3, Cin, Cout) of y = conv3x3(x, weight) from x (B, H, W, Cin)
    and dy (B, H, W, Cout), float32: on the card the kernel conv3x3_dw
    (csrc/conv3x3.cu) on ``plan_conv3x3_dw``'s plan, one ``conv3x3_dw``
    launch counted as a backward launch (its split pass over dy and its
    split-K reduction part of it); ``conv3x3_dw_plain`` on the CPU."""
    if x.device.type == "cpu":
        return conv3x3_dw_plain(x, dy)
    if x.ndim != 4 or dy.ndim != 4 or x.shape[:3] != dy.shape[:3] or {x.dtype, dy.dtype} != {torch.float32} \
            or x.device != dy.device or not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError(f"conv3x3_dw: x {tuple(x.shape)} {x.dtype}, dy {tuple(dy.shape)} {dy.dtype}")
    b, h, w, cin = x.shape
    cout = dy.shape[3]
    out = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    if x.numel() == 0 or out.numel() == 0:
        return out.zero_()
    return _launch_dw(x, dy, out, plan_conv3x3_dw(b, h, w, cin, cout, _aligned(x)))


def _launch_dw(x: Tensor, dy: Tensor, out: Tensor, plan: ConvPlan) -> Tensor:
    """Runs the weight-gradient ``plan`` into ``out`` on CUDA tensors that
    ``conv3x3_dw`` accepted."""
    b, h, w, cin = x.shape
    cout = dy.shape[3]
    kp = -(-b * h * w // (DW_CHAIN * F32_SLICE)) * DW_CHAIN * F32_SLICE  # "tf32x3" walks whole chains of slices
    dyt = torch.empty((2, cout, kp), dtype=torch.float32, device=x.device) if plan.variant == "tf32x3" else None
    partial = torch.empty((plan.splits, 9 * cin, cout), dtype=torch.float32, device=x.device) \
        if plan.splits > 1 else None
    fn = _build.entry("conv3x3", "conv3x3_dw", _DW_ARGTYPES)
    err = fn(x.data_ptr(), dy.data_ptr(), dyt.data_ptr() if dyt is not None else None, out.data_ptr(),
             partial.data_ptr() if partial is not None else None, b, h, w, cin, cout, _VARIANTS[plan.variant],
             plan.bn, plan.splits, kp, x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "conv3x3_dw")
    _build.count_launch("conv3x3_dw", x.shape, cout, backward=True, plan=plan.variant)
    return out


@torch.library.custom_op("diffsep::conv3x3", mutates_args=())
def _conv3x3_op(x: Tensor, weight: Tensor, bias: Optional[Tensor]) -> Tensor:
    return _forward(x, weight, bias)


@_conv3x3_op.register_fake
def _(x: Tensor, weight: Tensor, bias: Optional[Tensor]) -> Tensor:
    return x.new_empty((*x.shape[:3], weight.shape[3]))


def _setup_context(ctx, inputs, output) -> None:
    x, weight, _ = inputs
    ctx.save_for_backward(x, weight)


def _backward(ctx, grad: Tensor):
    """dx, dw and db where each is needed: the hand kernels for float32 on
    the card, the framework conv's backward otherwise (see the module
    docstring)."""
    x, weight = ctx.saved_tensors
    need_x, need_w, need_b = ctx.needs_input_grad
    grad = grad.contiguous()
    dx = dw = db = None
    if x.device.type == "cuda" and x.dtype == torch.float32:
        dx = conv3x3_dx(grad, weight) if need_x else None
        dw = conv3x3_dw(x, grad) if need_w else None
    elif need_x or need_w:
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


_conv3x3_op.register_autograd(_backward, setup_context=_setup_context)


def conv3x3(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None) -> Tensor:
    """y = conv(x, weight) + bias. x (B, H, W, Cin), weight (3, 3, Cin,
    Cout), bias (Cout,) or None; float32 or bfloat16, accumulated in f32.
    Differentiable in all three where grad mode is on."""
    if x.device.type not in ("cpu", "cuda"):  # the op would give a meta tensor its fake output
        raise ValueError(f"conv3x3: no kernel for device {x.device}")
    return _conv3x3_op(x, weight, bias)
