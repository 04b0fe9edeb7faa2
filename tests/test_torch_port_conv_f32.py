"""The float32 plan of diffsep_tpu_torch's 3x3 conv ("tf32x3": split-operand
TF32 on the tensor cores), checked on the CPU: its rounding and split
(ops/conv3x3.tf32_round, tf32_split_weight_plain), the operand layout the
kernel reads, the arithmetic of three TF32 products against float64 and
against diffsep_tpu's conv3x3_reference, and the planner's float32 rule.
The kernel itself runs on the card only (tests/test_torch_port_cuda.py).

Tolerances: hi + lo rebuilds a float32 value within 2^-22 of it (lo keeps
11 significant bits of a remainder below 2^-11 of the value); three TF32
products sum to within 1e-5 of scale of the float64 conv, while one TF32
product alone is off by more than the 1e-4 that the kernel is held to.
"""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsep_tpu.ops.pallas.conv3x3 import conv3x3_reference
from diffsep_tpu_torch.ops import conv3x3 as conv_mod
from test_torch_port_conv import FLAGSHIP_CONVS

# the f32 trunk convs beyond the flagship's: the 768-channel cat inputs of
# option set C, and the enhancement recipe's levels (batch 4 x 3 s and
# batch 1 at 16 kHz)
OPTION_CONVS = [((2, 16, 20, 768), 256), ((2, 32, 40, 768), 256)]
ENHANCE_CONVS = [
    ((4, 256, 384, 128), 128), ((4, 256, 384, 256), 128), ((4, 128, 192, 128), 128), ((4, 128, 192, 256), 256),
    ((4, 128, 192, 384), 128), ((4, 64, 96, 128), 256), ((4, 64, 96, 384), 256), ((4, 64, 96, 512), 256),
    ((4, 32, 48, 256), 256), ((4, 16, 24, 512), 256), ((4, 8, 12, 256), 256), ((4, 4, 6, 512), 256),
    ((1, 256, 512, 256), 128), ((1, 64, 64, 384), 256), ((1, 4, 4, 512), 256), ((1, 8, 16, 256), 256),
]
TRUNK = [(s, c) for s, c in FLAGSHIP_CONVS if s[3] % 32 == 0 and c % 64 == 0]
F32_TRUNK = ([((b, *s[1:]), c) for s, c in TRUNK for b in (2, 6)]
             + [((b, *s[1:]), c) for s, c in OPTION_CONVS for b in (2, 6)] + ENHANCE_CONVS)
# the output convs (Cout = 6) of the flagship at batch 2 and 6, and of the
# enhancement levels
F32_OUTPUT = ([((b, *s[1:]), c) for s, c in FLAGSHIP_CONVS if s[3] % 32 == 0 and c == 6 for b in (2, 6)]
              + [((4, 256, 384, 128), 6), ((4, 8, 12, 256), 6), ((1, 4, 4, 256), 6)])


def _tf32_numpy(v):
    """tf32 rounding written apart from the port's: 11 significant bits,
    ties away from zero, through float64 arithmetic."""
    v = np.asarray(v, np.float64)
    mant, exp = np.frexp(np.abs(v))  # |v| = mant * 2**exp, mant in [0.5, 1)
    q = np.floor(mant * 2.0**11 + 0.5)  # ties go up in magnitude
    return (np.sign(v) * np.ldexp(q, exp - 11)).astype(np.float32)


def test_tf32_round_and_split(rng):
    v = (rng.standard_normal(20000) * np.exp(rng.uniform(-30, 30, 20000))).astype(np.float32)
    ties = np.array([1 + 2.0**-11, -(1 + 2.0**-11), 3 * 2.0**-11 + 1], np.float32)  # exactly half a tf32 step
    v = np.concatenate([v, ties, np.float32([0.0, 1.0, -2.5])])
    t = torch.from_numpy(v)
    hi = conv_mod.tf32_round(t)
    lo = conv_mod.tf32_round(t - hi)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()  # 13 low mantissa bits zero
    np.testing.assert_array_equal(hi.numpy(), _tf32_numpy(v))
    assert hi[-6].item() == 1 + 2.0**-10 and hi[-5].item() == -(1 + 2.0**-10)  # away from zero
    rebuilt = hi.double() + lo.double()
    assert ((rebuilt - t.double()).abs() <= 2.0**-22 * t.double().abs()).all()
    assert ((hi.double() - t.double()).abs() > 2.0**-22 * t.double().abs()).any()


def _im2col(x):
    """(B, H, W, C) -> (B H W, 9 C), columns in (tap, channel) order."""
    b, h, w, _ = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], dim=3).reshape(b * h * w, -1)


def _kernel_a_operand(cols):
    """The A operand as the tf32x3 kernel's registers hold it: per 32-channel
    slice and k8 step kk, the thread of column group t puts channel 8 t + 2
    kk + (r >> 1) of its rows into register r, which the m16n8k8 tf32
    layout reads as column t + 4 (r >> 1) of the step."""
    a = torch.empty_like(cols)
    for s in range(cols.shape[1] // 32):
        for kk in range(4):
            for t in range(4):
                for r in range(0, 4, 2):  # registers 0, 2: row r0; 1, 3 repeat them 8 rows down
                    a[:, 32 * s + 8 * kk + t + 4 * (r >> 1)] = cols[:, 32 * s + 8 * t + 2 * kk + (r >> 1)]
    return a


def _tf32x3(x, weight, passes=3):
    """The kernel's arithmetic on the CPU: A split into hi + lo in
    registers, the split weight, and hi.hi + hi.lo + lo.hi (or hi.hi alone,
    ``passes=1``), each TF32 product exact, summed in float64."""
    b, h, w, _ = x.shape
    a = _kernel_a_operand(_im2col(x))
    a_hi = conv_mod.tf32_round(a)
    a_lo = conv_mod.tf32_round(a - a_hi)
    w_hi, w_lo = conv_mod.tf32_split_weight_plain(weight).double()
    y = a_hi.double() @ w_hi.T
    if passes == 3:
        y = y + a_hi.double() @ w_lo.T + a_lo.double() @ w_hi.T
    return y.reshape(b, h, w, -1)


@pytest.mark.parametrize("shape", [(1, 5, 6, 64, 64), (2, 4, 5, 96, 128)])
def test_split_weight_layout_matches_the_kernel_registers(rng, shape):
    """The split weight's permuted K columns meet the A fragments the kernel
    builds: hi + lo of the weight against the unsplit input gives the conv."""
    b, h, w, ci, co = shape
    x = torch.from_numpy(rng.standard_normal((b, h, w, ci)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((3, 3, ci, co)).astype(np.float32))
    split = conv_mod.tf32_split_weight_plain(k)
    assert split.shape == (2, co, 9 * ci) and split.dtype == torch.float32
    assert conv_mod.tf32_split_weight(k).equal(split)  # the CPU route is the plain version
    got = _kernel_a_operand(_im2col(x)).double() @ (split[0].double() + split[1].double()).T
    want = conv_mod.conv3x3_plain(x.double(), k.double())
    np.testing.assert_allclose(got.reshape(want.shape).numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_three_tf32_products_keep_float32_accuracy(rng):
    """At a deep flagship shape (K = 9 x 512) three TF32 products sit within
    1e-5 of scale of the float64 conv and of the JAX package's f32 one; a
    single TF32 product misses by more than 1e-4, so the kernel's
    tolerance would catch a kernel that dropped the correction terms."""
    x = rng.standard_normal((2, 4, 5, 512)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 512, 256)) / np.sqrt(9 * 512)).astype(np.float32)
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    want = conv_mod.conv3x3_plain(xt.double(), kt.double())
    scale = want.abs().max().item()
    three = (_tf32x3(xt, kt) - want).abs().max().item() / scale
    one = (_tf32x3(xt, kt, passes=1) - want).abs().max().item() / scale
    assert three <= 1e-5, three
    assert one > 1e-4, one
    jax_f32 = np.asarray(conv3x3_reference(jnp.asarray(x), jnp.asarray(k)))
    np.testing.assert_allclose(_tf32x3(xt, kt).numpy(), jax_f32, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("shape,cout", F32_TRUNK + F32_OUTPUT)
def test_float32_trunk_convs_take_the_tf32x3_plan(shape, cout):
    """Every f32 trunk conv (flagship at batch 2 and 6, option set C's cat
    inputs, the enhancement levels) and output conv (Cout = 6, on 8-wide N
    tiles) goes to an instantiated "tf32x3" plan that fits one block's
    shared memory and walks every 32-channel slice once over its splits;
    the deep levels split K, each split walking MIN_SLICES slices or more,
    within one wave (two of 64-row tiles); elsewhere K splits in two at
    most, where the cost model finds the last wave mostly empty."""
    b, h, w, cin = shape
    plan = conv_mod.plan_conv3x3(b, h, w, cin, cout, torch.float32)
    assert plan.variant == "tf32x3"
    assert (plan.variant, plan.bm, plan.bn, plan.stages) in conv_mod.INSTANCES
    assert 0 < plan.smem_bytes <= conv_mod.SMEM_LIMIT
    m, k_tiles = b * h * w, 9 * cin // conv_mod.F32_SLICE
    assert plan.grid == (-(-m // plan.bm), -(-cout // plan.bn), plan.splits)
    assert plan.bn == (8 if cout < 64 else 128 if cout % 128 == 0 and m >= 256 else 64)
    assert plan.bm == 64 or cout >= 64
    ranges = [(z * k_tiles // plan.splits, (z + 1) * k_tiles // plan.splits) for z in range(plan.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == k_tiles
    assert all(e - a >= (2 if cout < 64 else conv_mod.MIN_SLICES) for a, e in ranges)
    tiles = plan.grid[0] * plan.grid[1]
    # blocks that share an SM: five 64 x 8, two 64 x 64, one of the others
    waves = conv_mod.NARROW_WAVES if cout < 64 else 2 if plan.bm == 64 else 1
    if tiles < conv_mod.SMS // 2:  # the deep levels
        assert plan.splits > 1 and plan.blocks <= waves * conv_mod.SMS
    elif cout < 64:
        assert plan.splits == 1 or plan.blocks <= waves * conv_mod.SMS
    else:
        assert plan.splits <= 2
    if cout % 128 == 0 and m >= 256:
        assert plan.bm in (128, 192)


@pytest.mark.parametrize("shape,cout", [((2, 256, 320, 6), 128), ((6, 256, 320, 6), 128), ((2, 64, 80, 6), 6),
                                        ((2, 16, 20, 40), 128), ((2, 16, 20, 128), 72), ((1, 9, 7, 33), 64),
                                        ((1, 9, 7, 64), 96)])
def test_other_float32_convs_take_the_generic_plan(shape, cout):
    """Cin = 6 (the stem, the 6-channel pyramids) and channel counts off the
    32 x 64 grid (Cin % 32, Cout >= 64 with Cout % 64) stay on the generic
    kernel."""
    assert conv_mod.plan_conv3x3(*shape, cout, torch.float32).variant == "generic"


def test_split_weight_is_kept_per_weight_version_without_grad(rng):
    """The wrapper's split weight is made once per weight tensor and version
    where no gradient is recorded, anew after an in-place change, on every
    call in grad mode, and dropped with its weight."""
    k = torch.from_numpy(rng.standard_normal((3, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        first = conv_mod._split_weight(k)
        assert conv_mod._split_weight(k) is first
        k.mul_(2.0)
        second = conv_mod._split_weight(k)
    assert second is not first and second.equal(conv_mod.tf32_split_weight_plain(k))
    assert conv_mod._split_weight(k) is second  # an entry made without grad serves grad mode too
    fresh = k.clone()
    assert conv_mod._split_weight(fresh) is not conv_mod._split_weight(fresh)  # grad mode: not kept
    key = id(k)
    assert key in conv_mod._split_cache
    del k
    gc.collect()
    assert key not in conv_mod._split_cache
