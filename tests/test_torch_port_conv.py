"""diffsep_tpu_torch 3x3 conv (its CPU path, the plain version) vs
diffsep_tpu's conv3x3_reference (XLA) and its Pallas kernel in interpret
mode (CPU, float32). Each output sums 9 * Cin float32 products; atol 1e-4
on unit-scale inputs with 0.1-scale weights, as tests/test_pallas_conv.py.

Also the kernel plan (ops/conv3x3.plan_conv3x3, pure Python) at every conv
shape of one flagship score evaluation.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsep_tpu.ops.pallas.conv3x3 import _conv3x3_pallas, conv3x3_reference
from diffsep_tpu_torch.models.layers import Conv
from diffsep_tpu_torch.ops import conv3x3 as conv_mod
from diffsep_tpu_torch.ops.conv3x3 import conv3x3

ATOL = 1e-4

# The 27 distinct conv shapes ((B, H, W, Cin), Cout) of one flagship NCSN++
# score evaluation at batch 2 x 5 s (`chip_smoke.py --report` writes a row for each).
FLAGSHIP_CONVS = [
    ((2, 256, 320, 6), 128), ((2, 256, 320, 128), 6), ((2, 256, 320, 128), 128),
    ((2, 256, 320, 256), 128), ((2, 128, 160, 128), 6), ((2, 128, 160, 128), 128),
    ((2, 128, 160, 256), 128), ((2, 128, 160, 256), 256), ((2, 128, 160, 384), 128),
    ((2, 64, 80, 128), 128), ((2, 64, 80, 128), 256), ((2, 64, 80, 256), 6),
    ((2, 64, 80, 256), 256), ((2, 64, 80, 384), 256), ((2, 64, 80, 512), 256),
    ((2, 32, 40, 256), 6), ((2, 32, 40, 256), 256), ((2, 32, 40, 512), 256),
    ((2, 16, 20, 256), 6), ((2, 16, 20, 256), 256), ((2, 16, 20, 512), 256),
    ((2, 8, 10, 256), 6), ((2, 8, 10, 256), 256), ((2, 8, 10, 512), 256),
    ((2, 4, 5, 256), 6), ((2, 4, 5, 256), 256), ((2, 4, 5, 512), 256),
]


@pytest.mark.parametrize(
    "shape",
    [(2, 8, 10, 8, 16), (1, 16, 20, 128, 64), (2, 4, 6, 3, 5), (1, 5, 7, 4, 4), (1, 4, 5, 6, 128)],
)
def test_conv3x3_matches_reference_and_pallas(rng, shape):
    b, h, w, ci, co = shape
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    k = (rng.standard_normal((3, 3, ci, co)) * 0.1).astype(np.float32)
    got = conv3x3(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    want = np.asarray(conv3x3_reference(jnp.asarray(x), jnp.asarray(k)))
    np.testing.assert_allclose(got, want, atol=ATOL)
    pallas = np.asarray(_conv3x3_pallas(jnp.asarray(x), jnp.asarray(k), interpret=True))
    np.testing.assert_allclose(got, pallas, atol=ATOL)


def test_conv3x3_bias_and_edges():
    x = torch.ones((1, 4, 5, 1))
    k = torch.ones((3, 3, 1, 1))
    out = conv3x3(x, k, torch.tensor([0.5]))[0, :, :, 0]
    assert out[0, 0] == 4.5 and out[0, 2] == 6.5 and out[2, 2] == 9.5


def test_conv_module_caches_the_kernel_weight(rng):
    """Without grad mode (serving) the HWIO copy is made once per weight
    version: a second call reuses it, a load_state_dict (in-place copy)
    replaces it. (In grad mode the copy is made per call, differentiably:
    tests/test_torch_port_autograd.py.)"""
    conv = Conv(4, 8, 3)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.standard_normal((1, 6, 7, 4)).astype(np.float32))
    with torch.no_grad():
        y0 = conv(x)
        cached = conv._hwio[1]
        conv(x)
    assert conv._hwio[1] is cached
    w = torch.from_numpy(rng.standard_normal((8, 4, 3, 3)).astype(np.float32))
    conv.load_state_dict({"weight": w, "bias": torch.zeros(8)})
    with torch.no_grad():
        y1 = conv(x)
    assert conv._hwio[1] is not cached
    want = conv3x3_reference(jnp.asarray(x.numpy()), jnp.asarray(w.numpy().transpose(2, 3, 1, 0)))
    np.testing.assert_allclose(y1.detach().numpy(), np.asarray(want), atol=ATOL)
    assert not torch.allclose(y0, y1)


@pytest.mark.parametrize("shape,cout", FLAGSHIP_CONVS)
def test_conv3x3_plan_at_flagship_shapes(shape, cout):
    """Each bf16 plan fits one block's shared memory, is an instantiated
    kernel, walks every K slice exactly once over its splits, and uses the
    card: a split plan keeps its blocks within one wave (two for the narrow
    kernel) and at half a wave or more unless its splits are down to
    MIN_SLICES slices each; an unsplit plan has tiles enough for half a
    wave or more, or nothing left to split. The levels from 32 x 40 up go
    to the "tma" kernels, whose patches cover at most a quarter more pixels
    than the images have. Cin = 6 (the stem) goes to the generic kernel;
    float32 takes the "tf32x3" plan where Cin % 32 == 0 and Cout % 64 == 0
    or Cout < 64 (tests/test_torch_port_conv_f32.py), else the generic
    kernel."""
    b, h, w, cin = shape
    plan = conv_mod.plan_conv3x3(b, h, w, cin, cout, torch.bfloat16)
    m = b * h * w
    f32 = "tf32x3" if cin % 32 == 0 and (cout < 64 or cout % 64 == 0) else "generic"
    assert conv_mod.plan_conv3x3(b, h, w, cin, cout, torch.float32).variant == f32
    if cin == 6:
        assert plan.variant == "generic" and plan.splits == 1
        return
    assert (plan.variant, plan.bm, plan.bn, plan.stages) in conv_mod.INSTANCES
    assert 0 < plan.smem_bytes <= conv_mod.SMEM_LIMIT == 232_448
    k_tiles = 9 * cin // conv_mod.SLICE
    # the K slices [begin, end) of each split, as the kernels compute them from blockIdx.z
    ranges = [(z * k_tiles // plan.splits, (z + 1) * k_tiles // plan.splits) for z in range(plan.splits)]
    assert [r[0] for r in ranges[1:]] == [r[1] for r in ranges[:-1]]
    assert ranges[0][0] == 0 and ranges[-1][1] == k_tiles and all(e > a for a, e in ranges)
    if cout < 64:
        assert plan.variant == ("tma_narrow" if m >= 256 * conv_mod.SMS // 2 else "narrow")
    elif m >= 128 * conv_mod.SMS // 2:
        assert plan.variant == "tma" and plan.splits == 1
    else:  # 8 x 16 patches cover 32 x 40 images with 20% to spare, 16 x 20 with 60%
        assert plan.variant == ("tma" if h >= 32 else "wgmma")
    if plan.variant.startswith("tma"):
        th, tw = plan.bm // conv_mod.TMA_W, conv_mod.TMA_W
        patches = b * -(-h // th) * -(-w // tw)
        assert 4 * patches * plan.bm <= 5 * m
        if plan.variant == "tma_narrow":  # each block walks patches
            patches = min(patches, conv_mod.SMS)
        assert plan.grid == (patches, -(-cout // plan.bn), plan.splits)
    else:
        assert plan.grid == (-(-m // plan.bm), -(-cout // plan.bn), plan.splits)
    tiles = plan.grid[0] * plan.grid[1]
    waves = 2 if plan.variant == "narrow" else 1
    if plan.splits > 1:
        assert tiles < conv_mod.SMS and plan.blocks <= waves * conv_mod.SMS
        assert (plan.blocks >= conv_mod.SMS // 2
                or plan.splits == k_tiles // conv_mod.MIN_SLICES), plan
    else:
        assert tiles >= conv_mod.SMS // 2 or k_tiles // conv_mod.MIN_SLICES <= 1, plan


def test_conv3x3_plan_dispatch():
    """Shapes the wgmma and narrow kernels do not take go to the generic
    kernel: Cin not a multiple of 64, or Cout >= 64 not a multiple of 64."""
    assert conv_mod.plan_conv3x3(2, 16, 20, 40, 128).variant == "generic"
    assert conv_mod.plan_conv3x3(2, 16, 20, 128, 72).variant == "generic"
    assert conv_mod.plan_conv3x3(2, 16, 20, 128, 20).variant == "narrow"
    assert conv_mod.plan_conv3x3(2, 16, 20, 128, 192).variant == "wgmma"
    # 8 x 16 patches would cover 3-pixel-wide images five times over
    assert conv_mod.plan_conv3x3(8, 700, 3, 64, 128).variant == "wgmma"
    assert conv_mod.plan_conv3x3(8, 704, 16, 64, 128).variant == "tma"
