"""The FIR 2x kernels' plan (diffsep_tpu_torch/ops/fir_resample2x.py
plan_fir2x, pure Python) at every FIR shape of one flagship score
evaluation, and how its blocks and threads cover the output, mirrored from
the index arithmetic of csrc/fir_resample2x.cu.
"""
import numpy as np
import pytest
import torch

from diffsep_tpu_torch.ops import fir_resample2x as fir
from diffsep_tpu_torch.ops import upfirdn2d

# The 24 distinct FIR shapes ((B, H, W, C) input, up) of one flagship NCSN++
# score evaluation at batch 2 x 5 s: each down and up block resamples h and
# x at its level's width, the input pyramid goes down and the output
# pyramid up at 6 channels (PERF.md, per-shape FIR table).
LEVELS = [(256, 320), (128, 160), (64, 80), (32, 40), (16, 20), (8, 10), (4, 5)]
WIDTHS = [128, 128, 256, 256, 256, 256, 256]
FLAGSHIP_FIRS = (
    [((2, h, w, c), False) for (h, w), c in zip(LEVELS[:6], WIDTHS[:6])]
    + [((2, h, w, 6), False) for h, w in LEVELS[:6]]
    + [((2, h, w, c), True) for (h, w), c in zip(LEVELS[1:], WIDTHS[1:])]
    + [((2, h, w, 6), True) for h, w in LEVELS[1:]]
)


def _coverage(plan, shape, up):
    """How often each (batch, step, column, 8-channel group) is computed:
    a step is an output row (down) or an input row whose two output rows a
    thread forms (up); a column an output column (down) or an input column
    whose two output columns it forms (up)."""
    b, h, w, c = shape
    steps, cols = (h, w) if up else (h // 2, w // 2)
    if plan.variant == "tma":
        gx, gy, gz = plan.grid
        bx, by, bz, tid = np.meshgrid(np.arange(gx), np.arange(gy), np.arange(gz), np.arange(plan.threads),
                                      indexing="ij")
        chunks = c // fir.TMA_C
        bb, chunk = bz // chunks, bz % chunks
        j = bx * plan.cols + (tid >> 3)
        group = chunk * (fir.TMA_C // plan.vec) + (tid & 7)
        strip = by
        valid = j < cols
        groups = c // plan.vec
    else:
        groups = c // plan.vec
        t = np.arange(plan.grid[0] * plan.threads)
        group, t = t % groups, t // groups
        j, t = t % cols, t // cols
        strips = -(-steps // plan.rows)
        strip, bb = t % strips, t // strips
        valid = bb < b
    counts = np.zeros(b * steps * cols * groups, np.int64)
    for d in range(plan.rows):
        r = strip * plan.rows + d
        m = valid & (r < steps)
        counts += np.bincount((((bb * steps + r) * cols + j) * groups + group)[m], minlength=counts.size)
    return counts


@pytest.mark.parametrize("shape,up", FLAGSHIP_FIRS)
def test_fir_plan_at_flagship_shapes(shape, up):
    """The bf16 plan: "direct" at C = 6; at C = 128 and 256, "tma" for the
    calls on inputs from 64 x 80 (down) or 32 x 40 (up) up, "stream" for the
    deeper ones. It fits one block's shared memory, fills the card or walks
    single steps, and its threads compute every output exactly once.
    float32 goes to the "stream" kernel (or "direct" at C = 6), and an input
    off 16-byte alignment to "direct"."""
    b, h, w, c = shape
    plan = fir.plan_fir2x(b, h, w, c, torch.bfloat16, up)
    large = h >= (32 if up else 64)
    assert plan.variant == ("direct" if c == 6 else "tma" if large else "stream")
    assert 0 <= plan.smem_bytes <= fir.SMEM_LIMIT == 232_448
    if plan.variant == "tma":
        assert plan.smem_bytes == fir.tma_smem_bytes(up, plan.cols, plan.stages) > 0
        assert plan.threads == 8 * plan.cols and plan.cols == fir.TMA_COLS
        assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= fir.MIN_BLOCKS
    else:
        assert plan.smem_bytes == 0 and plan.threads == fir.THREADS and plan.vec == (1 if c == 6 else 8)
        assert plan.grid[0] * plan.threads >= fir.MIN_THREADS or plan.rows == 1
    assert (_coverage(plan, shape, up) == 1).all()
    f32 = fir.plan_fir2x(b, h, w, c, torch.float32, up)
    assert f32.variant == ("direct" if c == 6 else "stream") and (_coverage(f32, shape, up) == 1).all()
    unaligned = fir.plan_fir2x(b, h, w, c, torch.bfloat16, up, aligned=False)
    assert unaligned.variant == "direct" and (_coverage(unaligned, shape, up) == 1).all()


@pytest.mark.parametrize("up", [False, True])
@pytest.mark.parametrize(
    "shape,dtype,variant",
    [((2, 16, 20, 6), torch.bfloat16, "direct"), ((1, 7, 9, 3), torch.float32, "direct"),
     ((2, 12, 14, 40), torch.bfloat16, "stream"), ((2, 12, 14, 40), torch.float32, "stream"),
     ((1, 16, 20, 16), torch.bfloat16, "stream"), ((2, 5, 5, 256), torch.bfloat16, "stream"),
     ((1, 75, 150, 128), torch.bfloat16, "tma"), ((16, 65, 5, 256), torch.bfloat16, "tma"),
     ((4, 9, 700, 64), torch.bfloat16, "tma"), ((1, 75, 150, 128), torch.float32, "stream")],
)
def test_fir_plan_routing_and_coverage(shape, dtype, variant, up):
    """Off the flagship: 16-byte vectors where C allows them (C = 40 and 16
    in bf16, C % 4 == 0 in f32), single channels where it does not, TMA
    boxes for large bf16 calls at C % 64 == 0; odd and ragged sizes (W = 5,
    a strip that does not divide H, a ragged last tile) are still covered
    exactly once."""
    plan = fir.plan_fir2x(*shape, dtype, up)
    assert plan.variant == variant
    assert (_coverage(plan, shape, up) == 1).all()


def test_fir_plain_filter_is_made_once():
    """The plain version's 4 x 4 filter is built once per (kernel, device,
    dtype) and reused, so a call on the card copies nothing from the host."""
    x = torch.randn(1, 8, 8, 4)
    taps = (0.125, 0.375, 0.375, 0.125)
    fir.fir_down2x_plain(x, taps)
    before = upfirdn2d._flipped.cache_info().hits
    fir.fir_down2x_plain(x, taps)
    assert upfirdn2d._flipped.cache_info().hits == before + 1
