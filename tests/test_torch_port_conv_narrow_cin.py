"""The bf16 conv at 32-channel K slices: the "slice32" plan of
diffsep_tpu_torch.ops.conv3x3 (bf16 with Cin % 32 == 0 and Cin % 64 != 0:
the learning demo's Cin 32 and 96), on the CPU.

- The planner at every conv shape of the learning demo's NCSN++ (nf 32,
  ch_mult (1, 1, 2); scripts/torch_port_train_demo.py) at its training
  batch (16) and its evaluation batch (8).
- Every other plan unchanged: tests/torch_port_conv_plans_frozen.txt holds
  the plan of every flagship, option-set, enhancement, serving and
  tensor-parallel conv shape as the planner gave it before these plans
  existed; the planner must give each of them exactly.
- The plain version, which the kernels are held to on the card, against
  the JAX package's conv3x3_reference (XLA) and its Pallas kernel in
  interpret mode at Cin 32 and 96 on bf16 values. In float32 both sides sum
  the same exact products (a product of two bf16 values is exact in
  float32) in other orders: atol 1e-4 on unit-scale inputs with 0.1-scale
  weights, as tests/test_torch_port_conv.py. In bf16 each side rounds its
  f32 sum once: within one bf16 step, 1e-2 of max(1, |reference|), as the
  card tests (tests/test_torch_port_cuda.py).
"""
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsep_tpu.ops.pallas.conv3x3 import _conv3x3_pallas, conv3x3_reference
from diffsep_tpu_torch.ops import conv3x3 as conv_mod

# ((H, W, Cin), Cout) of every conv of one learning-demo score evaluation on
# 1 s mixtures, with its launches per evaluation: the stem, 2 x 15 BigGAN
# blocks and 3 output-pyramid convs
DEMO_CONVS = [((256, 128, 6), 32, 1), ((256, 128, 32), 32, 6), ((256, 128, 32), 6, 1), ((128, 64, 32), 32, 6),
              ((128, 64, 32), 6, 1), ((64, 32, 32), 32, 2), ((64, 32, 32), 64, 1), ((128, 64, 96), 32, 1),
              ((64, 32, 96), 64, 1)]
DEMO_BATCHES = (16, 8)  # a training step, the evaluation
FROZEN = Path(__file__).with_name("torch_port_conv_plans_frozen.txt")
ATOL, BF16_TOL = 1e-4, 1e-2


def _frozen():
    """{family: [((b, h, w, cin, cout, dtype), ConvPlan)]} of the frozen file."""
    families, family = {}, None
    for line in FROZEN.read_text().splitlines():
        if line.startswith("# ") and len(line.split()) == 2:
            family = line.split()[1]
            families[family] = []
        elif line and not line.startswith("#"):
            f = line.split()
            b, h, w, cin, cout = map(int, f[:5])
            dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[f[5]]
            bm, bn, stages, splits, g0, g1, g2, smem = map(int, f[7:])
            families[family].append(((b, h, w, cin, cout, dtype),
                                     conv_mod.ConvPlan(f[6], bm, bn, stages, splits, (g0, g1, g2), smem)))
    return families


def _walk(plan, cin):
    """The (tap, 32-channel slice) pairs one patch of ``plan`` multiplies, in
    the order of the kernel's boxes (csrc/conv3x3.cu,
    conv3x3_slice32_kernel): one box per (slice c, dx), from which it takes
    the taps dy = 0, 1, 2."""
    cs = cin // conv_mod.C32
    return [(dy * 3 + i % 3, i // 3) for i in range(3 * cs) for dy in range(3)]


@pytest.mark.parametrize("batch", DEMO_BATCHES)
@pytest.mark.parametrize("hwc,cout,per_eval", DEMO_CONVS)
def test_plan_at_demo_shapes(batch, hwc, cout, per_eval):
    """Cin 32 and 96 take the "slice32" plan: an instantiated kernel whose
    shared memory (the ring and the resident weight) fits one block, with
    an N tile of 32 (two of them at Cout 64: these images are too small to
    fill the card with 64-wide tiles) or 8 for the output convs, one block
    per SM over the Cout tiles, walking patches that cover the
    images, each patch multiplying every (tap, slice) of K exactly once,
    unsplit. The stem (Cin 6) stays on the generic kernel."""
    h, w, cin = hwc
    plan = conv_mod.plan_conv3x3(batch, h, w, cin, cout, torch.bfloat16)
    if cin == 6:
        assert plan.variant == "generic" and plan.splits == 1
        return
    assert plan.variant == "slice32"
    assert (plan.variant, plan.bm, plan.bn, plan.stages) in conv_mod.INSTANCES
    assert 0 < plan.smem_bytes <= conv_mod.SMEM_LIMIT == 232_448
    assert plan.smem_bytes == conv_mod._smem_bytes(plan.variant, plan.bm, plan.bn, plan.stages, 9 * cin // 32)
    assert plan.bn == {64: 32, 32: 32, 6: 8}[cout]
    n_tiles = -(-cout // plan.bn)
    patches = batch * -(-h // (plan.bm // conv_mod.TMA_W)) * -(-w // conv_mod.TMA_W)
    assert plan.grid == (min(patches, conv_mod.SMS // n_tiles), n_tiles, 1) and plan.splits == 1
    assert plan.blocks <= conv_mod.SMS
    walk = _walk(plan, cin)
    assert sorted(walk) == [(tap, c) for tap in range(9) for c in range(cin // 32)]


def test_off_grid_channels_and_the_stem_stay_generic():
    """bf16 Cin not a multiple of 32 (the stem's 6, 40) takes the generic
    kernel; Cin % 32 == 0 with Cout >= 64 not a multiple of 32 does too."""
    for b, h, w, cin, cout in [(16, 256, 128, 6, 32), (8, 256, 128, 6, 32), (2, 16, 20, 40, 128),
                               (2, 16, 20, 40, 6), (16, 64, 32, 96, 72), (2, 16, 20, 32, 100)]:
        assert conv_mod.plan_conv3x3(b, h, w, cin, cout).variant == "generic", (b, h, w, cin, cout)
    assert conv_mod.plan_conv3x3(2, 16, 20, 96, 96).variant == "slice32"  # three 32-wide tiles
    assert conv_mod.plan_conv3x3(2, 16, 20, 32, 20).bn == 8  # three 8-wide tiles


@pytest.mark.parametrize("cin", [32, 96, 160, 224, 288])
def test_c32_plans_fit_shared_memory(cin):
    """Every plan fits one block, its N tile 32 wide where Cout % 32 == 0,
    else 8 (Cout < 64); where even the 8 x 16 patches leave no room for the
    32-wide tile's resident weight (Cin 288), Cout 32 takes the 8-wide tile
    and Cout >= 64 goes to the generic kernel."""
    for cout in (6, 20, 32, 64, 96, 128, 256):
        plan = conv_mod.plan_conv3x3(4, 64, 80, cin, cout)
        if plan.variant == "generic":
            continue
        assert plan.smem_bytes <= conv_mod.SMEM_LIMIT and (plan.variant, plan.bm, plan.bn, plan.stages) in \
            conv_mod.INSTANCES
        assert plan.grid[1] * plan.bn >= cout and (cout % plan.bn == 0 or cout < 64)
        assert plan.bn == (32 if cout % 32 == 0 and cin < 288 else 8)
    assert conv_mod.plan_conv3x3(4, 64, 80, 160, 64).bn == 32
    wide = conv_mod.plan_conv3x3(16, 256, 128, cin, 64)
    assert wide.variant == "generic" if cin == 288 else wide.bn == 32


@pytest.mark.parametrize("family", ["flagship", "options", "enhancement", "serving", "tensor_parallel"])
def test_plans_elsewhere_are_unchanged(family):
    """Every frozen shape (Cin % 64 == 0, or the stem) gets the plan it had
    before the 32-channel-slice plans, field for field."""
    rows = _frozen()[family]
    assert rows
    for (b, h, w, cin, cout, dtype), want in rows:
        assert cin % 64 == 0 or cin == 6
        assert conv_mod.plan_conv3x3(b, h, w, cin, cout, dtype) == want, (b, h, w, cin, cout, dtype)


@pytest.mark.parametrize("shape", [(2, 40, 24, 32, 32), (1, 17, 19, 96, 64)])
def test_launch_passes_the_planned_grid(monkeypatch, shape):
    """The wrapper hands the C entry point the plan, argument for argument,
    and the plan's grid width (the persistent blocks per Cout tile) as its
    `blocks`: the grid that launches is the one the planner chose and these
    tests check. The entry point and the stream are stand-ins here."""
    calls = []
    monkeypatch.setattr(conv_mod._build, "entry", lambda lib, name, argtypes: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(conv_mod._build, "count_launch", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    b, h, w, cin, cout = shape
    plan = conv_mod.plan_conv3x3(*shape)
    assert plan.variant == "slice32"
    x = torch.zeros((b, h, w, cin), dtype=torch.bfloat16)
    out = conv_mod._launch(x, torch.zeros((3, 3, cin, cout), dtype=torch.bfloat16), None, plan)
    assert out.shape == (b, h, w, cout) and len(calls) == 1 and len(calls[0]) == len(conv_mod._ARGTYPES)
    assert calls[0][5:17] == (b, h, w, cin, cout, 1, conv_mod._VARIANTS["slice32"], plan.bm, plan.bn, plan.stages,
                              1, plan.grid[0])


@pytest.mark.parametrize("shape", [(2, 8, 10, 32, 32), (1, 9, 7, 96, 64), (2, 5, 6, 32, 6), (1, 6, 8, 96, 32)])
def test_plain_matches_jax_at_cin_32_and_96(rng, shape):
    b, h, w, ci, co = shape
    x = torch.from_numpy(rng.standard_normal((b, h, w, ci)).astype(np.float32)).bfloat16()
    k = torch.from_numpy((rng.standard_normal((3, 3, ci, co)) * 0.1).astype(np.float32)).bfloat16()
    # float32 on bf16 values
    xf, kf = x.float().numpy(), k.float().numpy()
    got = conv_mod.conv3x3_plain(x.float(), k.float()).numpy()
    np.testing.assert_allclose(got, np.asarray(conv3x3_reference(jnp.asarray(xf), jnp.asarray(kf))), atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(_conv3x3_pallas(jnp.asarray(xf), jnp.asarray(kf), interpret=True)),
                               atol=ATOL)
    # bf16 in and out: one rounding each
    got16 = conv_mod.conv3x3_plain(x, k).float().numpy()
    want16 = np.asarray(_conv3x3_pallas(jnp.asarray(xf, jnp.bfloat16), jnp.asarray(kf, jnp.bfloat16),
                                        interpret=True).astype(jnp.float32))
    assert np.abs(got16 - want16).max() <= BF16_TOL * max(1.0, np.abs(want16).max())
