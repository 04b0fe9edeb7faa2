"""Hand-written CUDA kernels vs their plain PyTorch versions, on the card.

Marked `cuda`: every test skips where no CUDA device is present. They
import neither JAX nor the JAX package and use no conftest fixture, so
they run on a machine with the card and without JAX:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Tolerances, of max(1, |plain|): float32 kernels accumulate in float32 like
the plain versions (cuDNN with TF32 off), so they agree to 1e-4 (measured
<= 1.6e-5 for the generic conv's 9 * Cin terms, <= 5e-7 for the FIR; the
"tf32x3" conv's three TF32 products per term lose under 2^-21 of each,
and its f32 accumulation on the tensor cores reads up to 3.8e-5 at 9 x 768
terms unsplit). bfloat16
outputs are each rounded once from an f32 sum on both sides; they differ
by at most about one bf16 step, held to 1e-2.
"""
import dataclasses

import numpy as np
import pytest
import torch

from diffsep_tpu_torch.ops import _build, conv3x3, fir_resample2x

pytestmark = pytest.mark.cuda

TAPS_DOWN = (0.125, 0.375, 0.375, 0.125)
# an asymmetric set shows that the kernel flips the taps (convolution) and
# applies each axis's taps in order
TAPS_DOWN_ASYM = (0.125, 0.25, 0.5, 0.125)
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * max(1.0, want.float().abs().max().item()), err


def _conv_inputs(dev, dtype, shape):
    b, h, w, ci, co = shape
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((b, h, w, ci), generator=g, device=dev).to(dtype)
    k = (torch.randn((3, 3, ci, co), generator=g, device=dev) / (9 * ci) ** 0.5).to(dtype)
    bias = torch.randn((co,), generator=g, device=dev).to(dtype)
    return x, k, bias


# In bf16 these reach every plan of ops/conv3x3.plan_conv3x3 and its edges:
# the stem and Cin = 40 (generic); narrow split with 64 and 128 rows,
# unsplit (3-pixel-wide images) and over three N tiles (Cout = 20);
# tma_narrow past the bottom and right edges (130 x 131) and over three N
# tiles with Cin = 64 (64 x 200); wgmma split on 64 x 64 tiles with M < 64,
# on 128 x 128 tiles with Cin = 320 (45 slices in 11 splits) and a ragged M
# (2 x 33 x 41); wgmma unsplit on 64 x 64 (Cout = 192) and 128 x 128
# (3-pixel-wide images); tma split past the right edge with Cin = 384 (54
# slices in 5 splits, 32 x 40); tma at 128 x 128 past the bottom and right
# edges (130 x 131), at 128 x 256 exact (128 x 160) and past the bottom
# edge with Cin = 64 (66 x 128), and at 256 x 128 past both edges
# (260 x 262).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape", [(2, 16, 20, 6, 128), (1, 9, 7, 128, 6), (2, 8, 10, 256, 128), (1, 4, 5, 512, 256),
              (1, 3, 70, 40, 72), (2, 2, 3, 256, 256), (2, 16, 20, 320, 256), (2, 33, 41, 128, 128),
              (2, 32, 40, 384, 128), (2, 64, 80, 128, 6), (1, 12, 10, 192, 20),
              (1, 130, 131, 128, 128), (2, 128, 160, 256, 256), (1, 130, 131, 128, 6),
              (1, 40, 50, 64, 192), (1, 66, 128, 64, 256), (8, 700, 3, 64, 128),
              (2, 260, 262, 64, 128), (16, 700, 3, 64, 6), (1, 64, 200, 64, 20)],
)
def test_conv3x3_kernel_matches_plain(dev, dtype, shape):
    x, k, bias = _conv_inputs(dev, dtype, shape)
    n0 = _build.launch_counts["conv3x3"]
    got = conv3x3.conv3x3(x, k, bias)
    torch.cuda.synchronize()
    assert _build.launch_counts["conv3x3"] == n0 + 1
    assert got.dtype == dtype and got.shape == (*x.shape[:3], k.shape[3])
    _close(got, conv3x3.conv3x3_plain(x, k, bias), dtype)
    _close(conv3x3.conv3x3(x, k), conv3x3.conv3x3_plain(x, k), dtype)


@pytest.mark.parametrize("shape", [(2, 4, 5, 512, 256), (2, 8, 10, 256, 6), (2, 32, 40, 256, 256)])
def test_conv3x3_split_k_is_bitwise_deterministic(dev, shape):
    x, k, bias = _conv_inputs(dev, torch.bfloat16, shape)
    assert conv3x3.plan_conv3x3(*shape, torch.bfloat16).splits > 1
    first = conv3x3.conv3x3(x, k, bias)
    second = conv3x3.conv3x3(x, k, bias)
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


def test_conv3x3_unaligned_input_takes_the_generic_kernel(dev):
    """The wgmma kernels copy 16-byte rows; an input 2 bytes off that
    alignment goes to the generic kernel and still matches."""
    x, k, bias = _conv_inputs(dev, torch.bfloat16, (1, 16, 20, 128, 128))
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 and conv3x3.plan_conv3x3(*x.shape, 128).variant != "generic"
    _close(conv3x3.conv3x3(shifted, k, bias), conv3x3.conv3x3_plain(x, k, bias), torch.bfloat16)


# bf16 with Cin % 32 == 0 and Cin % 64 != 0: the "slice32" plan (32-channel
# K slices in the 64-byte swizzle). Cin 32, 96 and 160 (one, three and five
# slices) with Cout 6 (the 8-wide tile), 20 (three of them), 32, 64 and 128
# (two and four 32-wide tiles); ragged M and odd H and W, patches past
# the bottom and right edges, images narrower than a patch; the learning
# demo's Cin 32 and 96 shapes at batch 16 and 8.
C32_SHAPES = [(2, 33, 41, 32, 32), (1, 17, 19, 96, 64), (3, 9, 7, 160, 128), (2, 64, 32, 32, 6),
              (1, 130, 131, 96, 6), (2, 31, 45, 160, 64), (1, 5, 3, 32, 32), (1, 40, 50, 96, 128),
              (2, 20, 24, 32, 20), (1, 16, 16, 160, 6), (1, 23, 70, 32, 128), (2, 45, 29, 96, 32),
              (16, 256, 128, 32, 32), (16, 256, 128, 32, 6), (16, 128, 64, 32, 32), (16, 128, 64, 32, 6),
              (16, 64, 32, 32, 32), (16, 64, 32, 32, 64), (16, 128, 64, 96, 32), (16, 64, 32, 96, 64),
              (8, 256, 128, 32, 32), (8, 64, 32, 96, 64)]


@pytest.mark.parametrize("shape", C32_SHAPES)
def test_conv3x3_c32_matches_plain(dev, shape):
    """The planner's plan, with and without bias: one counted launch, the
    plain version's values within one bf16 step."""
    x, k, bias = _conv_inputs(dev, torch.bfloat16, shape)
    assert conv3x3.plan_conv3x3(*shape).variant == "slice32"
    n0 = _build.launch_counts["conv3x3"]
    got = conv3x3.conv3x3(x, k, bias)
    torch.cuda.synchronize()
    assert _build.launch_counts["conv3x3"] == n0 + 1
    assert got.dtype == torch.bfloat16 and got.shape == (*x.shape[:3], k.shape[3])
    _close(got, conv3x3.conv3x3_plain(x, k, bias), torch.bfloat16)
    _close(conv3x3.conv3x3(x, k), conv3x3.conv3x3_plain(x, k), torch.bfloat16)


def _c32_plans(shape):
    """Every "slice32" instance that takes this shape's Cout and fits, at
    each patch height and N tile width."""
    b, h, w, cin, cout = shape
    return [p for v, bm, bn, _ in conv3x3.INSTANCES if v == "slice32"
            for p in [conv3x3._c32(b, h, w, cin, cout, bm, bn)] if p is not None]


@pytest.mark.parametrize("shape", [(2, 33, 41, 32, 32), (1, 17, 19, 96, 64), (3, 9, 7, 160, 128),
                                   (1, 130, 131, 96, 6), (2, 20, 24, 32, 20), (16, 64, 32, 96, 64)])
def test_conv3x3_every_c32_plan_matches_plain(dev, shape):
    """Every instance at the planner's grid, and at grids of 1 and 7 blocks
    per Cout tile: the launch takes the plan's grid width, and each block
    walks every patch that falls to it."""
    x, k, bias = _conv_inputs(dev, torch.bfloat16, shape)
    want = conv3x3.conv3x3_plain(x, k, bias)
    plans = _c32_plans(shape)
    assert plans and {p.bm for p in plans} >= {128}
    for plan in plans:
        for width in {plan.grid[0], 1, 7}:
            grid = (width, *plan.grid[1:])
            _close(conv3x3._launch(x, k, bias, dataclasses.replace(plan, grid=grid)), want, torch.bfloat16)


def test_conv3x3_unaligned_c32_input_takes_the_generic_kernel(dev):
    """A bf16 input with Cin = 96, 2 bytes off the 16-byte alignment, goes to
    the generic kernel and still matches."""
    x, k, bias = _conv_inputs(dev, torch.bfloat16, (2, 17, 19, 96, 64))
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 and conv3x3.plan_conv3x3(*x.shape, 64).variant == "slice32"
    _close(conv3x3.conv3x3(shifted, k, bias), conv3x3.conv3x3_plain(x, k, bias), torch.bfloat16)


@pytest.mark.parametrize("shape", [(2, 33, 41, 32, 32), (2, 16, 20, 96, 64), (2, 32, 16, 32, 6)])
def test_conv3x3_c32_gradients_match_plain(dev, shape):
    x, k, bias = _conv_inputs(dev, torch.bfloat16, shape)
    g = torch.randn((*shape[:3], shape[4]), device=dev).to(torch.bfloat16)
    n0 = _build.launch_counts["conv3x3"]
    got = _grads(conv3x3.conv3x3, (x, k, bias), g)
    assert _build.launch_counts["conv3x3"] == n0 + 1
    want = _grads(conv3x3.conv3x3_plain, (x, k, bias), g)
    for a, b_ in zip(got, want):
        assert a.shape == b_.shape and a.dtype == b_.dtype
        _close(a, b_, torch.bfloat16)


# float32's "tf32x3" plan (split-operand TF32 on the tensor cores) at every
# f32 trunk conv that chip_smoke.py's kernel phase (batch 2) and phase 12
# (the f32 fallback recipe at batch 6, option set C's 768-channel cat
# inputs) reach, and ragged ones: M not a multiple of the 128-row tile
# (2 x 33 x 41), odd H and W with Cin = 160 (5 slices a tap) and Cin = 32
# (one), Cout = 192 on 64 x 64 tiles (7 x 9, and 131 x 129 unsplit).
# The output convs (Cout = 6) take its 8-wide tile: the flagship's at
# batch 2 and 6, Cout = 20 over three N tiles, and past the bottom and
# right edges (130 x 131).
F32_TRUNK = [(2, 256, 320, 128, 128), (2, 256, 320, 256, 128), (2, 128, 160, 128, 128),
             (2, 128, 160, 256, 128), (2, 128, 160, 256, 256), (2, 128, 160, 384, 128),
             (2, 64, 80, 128, 128), (2, 64, 80, 128, 256), (2, 64, 80, 256, 256), (2, 64, 80, 384, 256),
             (2, 64, 80, 512, 256), (2, 32, 40, 256, 256), (2, 32, 40, 512, 256), (2, 16, 20, 256, 256),
             (2, 16, 20, 512, 256), (2, 8, 10, 256, 256), (2, 8, 10, 512, 256), (2, 4, 5, 256, 256),
             (2, 4, 5, 512, 256), (2, 16, 20, 768, 256), (2, 32, 40, 768, 256)]
F32_OUTPUT = [(2, 256, 320, 128, 6), (2, 128, 160, 128, 6), (2, 64, 80, 256, 6), (2, 32, 40, 256, 6),
              (2, 16, 20, 256, 6), (2, 8, 10, 256, 6), (2, 4, 5, 256, 6)]
F32_SHAPES = (F32_TRUNK + F32_OUTPUT + [(6, *s[1:]) for s in F32_TRUNK + F32_OUTPUT]
              + [(2, 33, 41, 128, 128), (3, 17, 19, 160, 128), (1, 5, 7, 32, 64), (1, 7, 9, 64, 192),
                 (1, 131, 129, 96, 192), (1, 9, 7, 64, 20), (1, 130, 131, 128, 6)])


@pytest.mark.parametrize("shape", F32_SHAPES)
def test_conv3x3_tf32x3_matches_plain(dev, shape):
    """With and without bias; the split weight kept (no grad) and made per
    call (grad mode)."""
    x, k, bias = _conv_inputs(dev, torch.float32, shape)
    assert conv3x3.plan_conv3x3(*shape, torch.float32).variant == "tf32x3"
    n0 = _build.launch_counts["conv3x3"]
    with torch.no_grad():
        got = conv3x3.conv3x3(x, k, bias)
    torch.cuda.synchronize()
    assert _build.launch_counts["conv3x3"] == n0 + 1
    assert got.dtype == torch.float32 and got.shape == (*x.shape[:3], k.shape[3])
    _close(got, conv3x3.conv3x3_plain(x, k, bias), torch.float32)
    _close(conv3x3.conv3x3(x, k), conv3x3.conv3x3_plain(x, k), torch.float32)


@pytest.mark.parametrize("shape", [(2, 4, 5, 512, 256), (2, 16, 20, 768, 256), (2, 32, 40, 256, 256),
                                   (6, 8, 10, 512, 256)])
def test_conv3x3_f32_split_k_is_bitwise_deterministic(dev, shape):
    x, k, bias = _conv_inputs(dev, torch.float32, shape)
    plan = conv3x3.plan_conv3x3(*shape, torch.float32)
    assert plan.variant == "tf32x3" and plan.splits > 1
    first = conv3x3.conv3x3(x, k, bias)
    second = conv3x3.conv3x3(x, k, bias)
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


@pytest.mark.parametrize("shape", [(3, 3, 32, 64), (3, 3, 128, 192), (3, 3, 768, 256), (3, 3, 64, 6)])
def test_tf32_split_weight_kernel_equals_plain(dev, shape):
    k = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    got = conv3x3.tf32_split_weight(k)
    want = conv3x3.tf32_split_weight_plain(k)
    assert got.shape == want.shape and torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_conv3x3_unaligned_f32_input_takes_the_generic_kernel(dev):
    """A float32 input 4 bytes off the 16-byte alignment goes to the generic
    kernel (CUDA cores) and still matches."""
    x, k, bias = _conv_inputs(dev, torch.float32, (1, 16, 20, 128, 128))
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 and conv3x3.plan_conv3x3(*x.shape, 128, torch.float32).variant == "tf32x3"
    _close(conv3x3.conv3x3(shifted, k, bias), conv3x3.conv3x3_plain(x, k, bias), torch.float32)


# The float32 conv's backward on the card: dx on the forward's kernels
# (the flipped, transposed weight), dw on conv3x3_dw. Shapes: batch 2 on 4 x
# 5, 7 x 6 and 16 x 20 at (Cin, Cout) = (6, 32) (the stem's "window" dw,
# its sides swapped), (32, 64), (64, 32), (96, 4) (a generic dx of Cin 4 and
# a "window" dw of 4 narrow channels) and (128, 128); every conv shape of
# the f32 + remat micro-step (the flagship at batch 6); and ragged ones: odd
# H and W with Cin = 160, Cout = 20 (the generic dw), the output conv past
# both edges, Cout = 96 on 32-wide tiles, a "window" dw over two blocks of
# wide channels with one channel in the second and 8 narrow ones (33 -> 8,
# 21 columns), both sides narrow (7 -> 7), an odd narrow side swapped (3 ->
# 40). Tolerance 2e-5 of max |plain| (cuDNN and cuBLAS with TF32 off): both
# sum the same f32 terms in other orders, dw over up to 491520 pixels.
BWD_SHAPES = ([(2, h, w, ci, co) for h, w in ((4, 5), (7, 6), (16, 20))
               for ci, co in ((6, 32), (32, 64), (64, 32), (96, 4), (128, 128))]
              + [(6, *s[1:]) for s in F32_TRUNK[:-2] + F32_OUTPUT] + [(6, 256, 320, 6, 128)]
              + [(3, 17, 19, 160, 128), (1, 9, 7, 64, 20), (1, 130, 131, 128, 6), (2, 33, 41, 32, 96),
                 (2, 16, 21, 33, 8), (3, 5, 9, 7, 7), (2, 7, 6, 3, 40)])
BWD_TOL = 2e-5


def _close_rel(got, want, tol=BWD_TOL):
    err = (got - want).abs().max().item()
    assert got.shape == want.shape and err <= tol * want.abs().max().item(), err


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_conv3x3_dx_and_dw_match_plain(dev, shape):
    x, k, _ = _conv_inputs(dev, torch.float32, shape)
    g = torch.randn((*shape[:3], shape[4]), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    n0, b0 = _build.backward_counts["conv3x3"], _build.backward_counts["conv3x3_dw"]
    dx, dw = conv3x3.conv3x3_dx(g, k), conv3x3.conv3x3_dw(x, g)
    torch.cuda.synchronize()
    assert (_build.backward_counts["conv3x3"], _build.backward_counts["conv3x3_dw"]) == (n0 + 1, b0 + 1)
    _close_rel(dx, conv3x3.conv3x3_dx_plain(g, k))
    _close_rel(dw, conv3x3.conv3x3_dw_plain(x, g))


@pytest.mark.parametrize("shape", [(6, 256, 320, 128, 128), (6, 64, 80, 512, 256), (2, 16, 20, 6, 32),
                                   (6, 128, 160, 128, 6), (2, 33, 41, 32, 96), (6, 256, 320, 6, 128),
                                   (2, 7, 6, 3, 40)])
def test_conv3x3_dw_is_bitwise_deterministic(dev, shape):
    x, _, _ = _conv_inputs(dev, torch.float32, shape)
    g = torch.randn((*shape[:3], shape[4]), device=dev)
    assert conv3x3.plan_conv3x3_dw(*shape).splits > 1
    first, second = conv3x3.conv3x3_dw(x, g), conv3x3.conv3x3_dw(x, g)
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


@pytest.mark.parametrize("shape", [(3, 3, 64, 32), (3, 3, 128, 192), (3, 3, 256, 768), (3, 3, 6, 64)])
def test_tf32_split_of_the_dx_weight_equals_plain(dev, shape):
    k = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    got = conv3x3.tf32_split_weight(k, flip=True)
    want = conv3x3.tf32_split_weight_plain(conv3x3.conv3x3_dx_weight(k))
    assert got.shape == want.shape and torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_conv3x3_backward_of_unaligned_tensors_takes_the_generic_kernels(dev):
    """x or dy 4 bytes off the 16-byte alignment: dw and dx go to the
    generic kernels and still match."""
    x, k, _ = _conv_inputs(dev, torch.float32, (1, 16, 20, 128, 128))
    g = torch.randn((1, 16, 20, 128), device=dev)

    def shifted(t):
        out = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape)
        return out.copy_(t)

    xs, gs = shifted(x), shifted(g)
    assert xs.data_ptr() % 16 and gs.data_ptr() % 16
    assert conv3x3.plan_conv3x3_dw(1, 16, 20, 128, 128, False).variant == "generic"
    _close_rel(conv3x3.conv3x3_dw(xs, g), conv3x3.conv3x3_dw_plain(x, g))
    _close_rel(conv3x3.conv3x3_dx(gs, k), conv3x3.conv3x3_dx_plain(g, k))


@pytest.mark.parametrize("shape", [(2, 16, 20, 128, 6), (2, 16, 20, 6, 128)])
def test_conv3x3_dw_window_of_unaligned_tensors_matches_plain(dev, shape):
    """x and dy 4 bytes off the 16-byte alignment: the "window" dw (an
    output conv's sides and the stem's) reads single floats, so it takes
    them as they are."""
    x, _, _ = _conv_inputs(dev, torch.float32, shape)
    g = torch.randn((*shape[:3], shape[4]), device=dev)

    def shifted(t):
        out = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape)
        return out.copy_(t)

    xs, gs = shifted(x), shifted(g)
    assert xs.data_ptr() % 16 and gs.data_ptr() % 16
    assert conv3x3.plan_conv3x3_dw(*shape, False).variant == "window"
    _close_rel(conv3x3.conv3x3_dw(xs, gs), conv3x3.conv3x3_dw_plain(x, g))


def test_f32_score_model_gradients_on_the_hand_backward_match_plain(dev):
    """A whole float32 NCSN++ score model (nf 32, the flagship's blocks):
    its parameter gradients with the hand dx and dw against the same model
    on the plain versions (cuDNN's backward), within 1e-4 of their norm; dx
    skips the stem (its input takes no gradient)."""
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.ops.plain import plain_kernels

    cfg = {"score_model": {"backbone_args": {"nf": 32, "ch_mult": (1, 1, 2, 2), "num_res_blocks": 1,
                                             "dtype": "float32"}}}
    _, model = _randomized_pair(lambda d: DiffSepModel(cfg, device=d).score_model, dev, 6)
    g = torch.Generator().manual_seed(7)
    inputs = (0.3 * torch.randn((2, 2, 8000), generator=g), torch.tensor([0.4, 0.9]),
              0.3 * torch.randn((2, 1, 8000), generator=g))
    w = torch.randn((2, 2, 8000), generator=g)
    _build.reset_counts()
    _, got = _forward_and_grads(model, inputs, w, dev)
    torch.cuda.synchronize()
    forward = _build.launch_counts["conv3x3"] - _build.backward_counts["conv3x3"]
    assert _build.backward_counts["conv3x3_dw"] == forward and 0 < _build.backward_counts["conv3x3"] < forward
    with plain_kernels():
        _, want = _forward_and_grads(model, inputs, w, dev)
    norm = sum(float(v.double().square().sum()) for v in want.values()) ** 0.5
    assert max(float((got[k] - want[k]).abs().max()) for k in want) <= 1e-4 * norm


def _fir_case(dev, dtype, shape, up, down_taps=TAPS_DOWN):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    taps = tuple(2 * t for t in down_taps) if up else down_taps
    plain = fir_resample2x.fir_up2x_plain if up else fir_resample2x.fir_down2x_plain
    return x, taps, plain(x, taps)


# In bf16 and f32 these reach every plan of ops/fir_resample2x.plan_fir2x
# and its edges: "direct" at C = 6 and 3 (odd H and W); "stream" at C = 40,
# 16 and 96, at small C % 64 == 0 calls (W = 5, odd 9 x 11) in bf16 and at
# every C % 4 == 0 in f32; "tma" at W = 5 (16 x 65 x 5), at odd H and W
# with strips that do not divide H (75 x 150), at a 700-column image with
# a ragged last tile, and at the flagship's largest shape both ways.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape", [(2, 16, 20, 6), (1, 8, 10, 128), (2, 5, 5, 256), (1, 7, 9, 3), (1, 32, 40, 96),
              (1, 16, 20, 16), (2, 12, 14, 40), (2, 9, 11, 64), (1, 75, 150, 128), (16, 65, 5, 256),
              (4, 9, 700, 64), (2, 256, 320, 128)],
)
@pytest.mark.parametrize("up", [False, True])
@pytest.mark.parametrize("down_taps", [TAPS_DOWN, TAPS_DOWN_ASYM], ids=["sym", "asym"])
def test_fir_kernels_match_plain(dev, dtype, shape, up, down_taps):
    x, taps, want = _fir_case(dev, dtype, shape, up, down_taps)
    name = "fir_up2x" if up else "fir_down2x"
    fn = fir_resample2x.fir_up2x if up else fir_resample2x.fir_down2x
    n0 = _build.launch_counts[name]
    got = fn(x, taps)
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == n0 + 1
    assert got.shape == want.shape and got.dtype == dtype
    _close(got, want, dtype)


def _fir_plans(shape, up):
    """Every variant at several strip, tile and ring geometries for a bf16
    input of this shape."""
    b, h, w, c = shape
    steps, cols = (h, w) if up else (h // 2, w // 2)
    plans = [fir_resample2x._stream("direct", 1, b, steps, cols, c, rows) for rows in (1, 4)]
    plans += [fir_resample2x._stream("stream", 8, b, steps, cols, c, rows) for rows in (1, 5, 64)]
    plans += [fir_resample2x._tma(b, steps, cols, c, up, tw, rows, stages)
              for tw, rows, stages in [(8, 1, 1), (16, 3, 2), (32, 32, 4), (32, 7, 3)]]
    return plans


@pytest.mark.parametrize("shape", [(1, 37, 24, 128), (2, 9, 11, 64), (2, 4, 5, 256), (2, 128, 160, 128)])
@pytest.mark.parametrize("up", [False, True])
def test_fir_every_plan_matches_plain(dev, shape, up):
    """Each kernel under strips of 1 to 64 steps, tiles of 8 to 32 columns
    and rings of 1 to 4 stages (a strip longer than the image, a ring deeper
    than the strip) gives the plain result, bitwise the same on a second
    call: a ring stage refilled before every thread has read it would show
    here, at the large shape, as a mismatch or a difference between calls."""
    x, taps, want = _fir_case(dev, torch.bfloat16, shape, up, TAPS_DOWN_ASYM)
    for plan in _fir_plans(shape, up):
        got = fir_resample2x._launch(x, taps, up, plan)
        again = fir_resample2x._launch(x, taps, up, plan)
        torch.cuda.synchronize()
        _close(got, want, torch.bfloat16)
        assert torch.equal(got.view(torch.int16), again.view(torch.int16)), plan


@pytest.mark.parametrize("up", [False, True])
def test_fir_unaligned_input_takes_the_direct_kernel(dev, up):
    """The 16-byte kernels need an aligned base address; an input 2 bytes off
    it goes to the direct kernel and still matches."""
    x, taps, want = _fir_case(dev, torch.bfloat16, (1, 64, 80, 128), up)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16
    assert fir_resample2x.plan_fir2x(*x.shape, x.dtype, up, aligned=False).variant == "direct"
    assert fir_resample2x.plan_fir2x(*x.shape, x.dtype, up).variant != "direct"
    fn = fir_resample2x.fir_up2x if up else fir_resample2x.fir_down2x
    _close(fn(shifted, taps), want, torch.bfloat16)


def test_wrappers_check_their_inputs(dev):
    x = torch.zeros((1, 4, 4, 8), device=dev)
    with pytest.raises(TypeError):
        conv3x3.conv3x3(x, torch.zeros((3, 3, 8, 4), device=dev, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        conv3x3.conv3x3(x.permute(0, 2, 1, 3), torch.zeros((3, 3, 8, 4), device=dev))
    with pytest.raises(ValueError):
        fir_resample2x.fir_down2x(x.to(torch.float16), TAPS_DOWN)


def test_small_model_on_the_card_matches_the_cpu(dev):
    from diffsep_tpu_torch.model import DiffSepModel

    cfg = {"score_model": {"backbone_args": {
        "nf": 16, "ch_mult": (1, 2, 2), "num_res_blocks": 1, "attn_resolutions": (16,),
        "image_size": 64, "dtype": "float32"}, "stft_args": {"n_fft": 126, "hop_length": 32}}}
    gpu = DiffSepModel(cfg, device=dev, seed=3)
    cpu = DiffSepModel(cfg, device="cpu", seed=3)
    rng = np.random.default_rng(0)
    xt = torch.from_numpy(rng.standard_normal((2, 2, 2000)).astype(np.float32))
    mix = torch.from_numpy(rng.standard_normal((2, 1, 2000)).astype(np.float32))
    t = torch.tensor([0.8, 0.1])
    _build.launch_counts.clear()
    with torch.no_grad():
        got = gpu.score_fn(xt.to(dev), t.to(dev), mix.to(dev)).cpu()
        want = cpu.score_fn(xt, t, mix)
    assert _build.launch_counts["conv3x3"] > 0 and _build.launch_counts["fir_up2x"] > 0
    assert (got - want).abs().max() <= 1e-3 * want.abs().max()


# --- gradients -----------------------------------------------------------
# The training path's shapes: one micro-step of the flagship recipe (NCSN++
# nf=128, bf16, batch 6 x 5 s), its loss's forward and backward on the card.
# Gradient tolerances are those of the outputs above, of max(1, |plain|):
# both sides sum the same terms in float32 (in bf16 the conv's backward is
# cuDNN's on both routes; in float32 the kernel route's is the hand dx and
# dw) and round once to the working type.
TRAIN_BATCH = 6


@pytest.fixture(scope="module")
def training_launches():
    """{(kernel, input shape, cout): launches} of one flagship micro-step,
    forward and backward, and of its backward alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.train.losses import Draws
    from diffsep_tpu_torch.train.trainer import make_loss_fn

    dev = torch.device("cuda")
    model = DiffSepModel(device=dev, seed=0)
    rng = np.random.default_rng(0)
    tgt = torch.from_numpy(0.1 * rng.standard_normal((TRAIN_BATCH, 2, 40000), dtype=np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    _build.reset_counts()
    loss = make_loss_fn(model.score_model, model.sde, model.loss_cfg)(
        Draws(gen), tgt.sum(dim=1, keepdim=True), tgt)
    loss.backward()
    torch.cuda.synchronize()
    out = dict(_build.launch_shapes), dict(_build.backward_shapes)
    _build.reset_counts()
    return out


def _shapes(launches, kernel):
    return sorted({(shape, cout) for (k, shape, cout) in launches if k == kernel})


def test_training_micro_step_launches(training_launches):
    """Per micro-step: conv3x3 106 forward (its backward is cuDNN's), FIR
    down 18 + 18 (the backward of every up), FIR up 18 + 12 (the backward
    of the 12 in-block downs; the input pyramid's 6 take no gradient)."""
    every, backward = training_launches

    def total(counter, kernel):
        return sum(n for (k, _, _), n in counter.items() if k == kernel)

    assert {k: total(every, k) for k in ("conv3x3", "fir_down2x", "fir_up2x")} == {
        "conv3x3": 106, "fir_down2x": 36, "fir_up2x": 30}
    assert {k: total(backward, k) for k in ("conv3x3", "fir_down2x", "fir_up2x")} == {
        "conv3x3": 0, "fir_down2x": 18, "fir_up2x": 12}


def _grads(fn, inputs, g):
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return (out, *torch.autograd.grad(out, leaves, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_gradients_match_plain_at_training_shapes(training_launches, dev, dtype):
    """bfloat16: one launch, the backward cuDNN's on both routes; float32:
    the forward and dx on conv3x3, dw on conv3x3_dw, held to their plain
    versions (cuDNN's own f32 weight gradient strays by about 1e-4 of its
    largest value over the 491520 pixels of the top level at batch 6,
    where conv3x3_dw_plain and the kernel agree within 2e-6)."""
    for (b, h, w, ci), co in _shapes(training_launches[0], "conv3x3"):
        x, k, bias = _conv_inputs(dev, dtype, (b, h, w, ci, co))
        g = torch.randn((b, h, w, co), device=dev).to(dtype)
        n0, d0 = _build.launch_counts["conv3x3"], _build.launch_counts["conv3x3_dw"]
        got = _grads(conv3x3.conv3x3, (x, k, bias), g)
        f32 = int(dtype == torch.float32)
        assert (_build.launch_counts["conv3x3"], _build.launch_counts["conv3x3_dw"]) == (n0 + 1 + f32, d0 + f32)
        want = _grads(conv3x3.conv3x3_plain, (x, k, bias), g)
        if f32:
            want = (want[0], conv3x3.conv3x3_dx_plain(g, k), conv3x3.conv3x3_dw_plain(x, g), want[3])
        for a, b_ in zip(got, want):
            assert a.shape == b_.shape and a.dtype == b_.dtype
            _close(a, b_, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("down_taps", [TAPS_DOWN, TAPS_DOWN_ASYM], ids=["sym", "asym"])
def test_fir_gradients_match_plain_at_training_shapes(training_launches, dev, dtype, down_taps):
    """Every shape a micro-step launches each direction at, forward or
    backward: the output, and the input gradient, which is the other kernel
    at the output's shape (so every backward launch's shape is among them)."""
    for up, name, other in [(False, "fir_down2x", "fir_up2x"), (True, "fir_up2x", "fir_down2x")]:
        fn = fir_resample2x.fir_up2x if up else fir_resample2x.fir_down2x
        plain = fir_resample2x.fir_up2x_plain if up else fir_resample2x.fir_down2x_plain
        for shape, _ in _shapes(training_launches[0], name):
            x, taps, _ = _fir_case(dev, dtype, shape, up, down_taps)
            g = torch.randn(plain(x, taps).shape, device=dev).to(dtype)
            n0, b0 = _build.launch_counts[name], _build.backward_counts[other]
            got = _grads(lambda t: fn(t, taps), (x,), g)
            assert _build.launch_counts[name] == n0 + 1 and _build.backward_counts[other] == b0 + 1
            want = _grads(lambda t: plain(t, taps), (x,), g)
            for a, b_ in zip(got, want):
                _close(a, b_, dtype)


@pytest.mark.parametrize("up", [False, True])
def test_fir_backward_repeats_bit_for_bit(dev, up):
    x, taps, want = _fir_case(dev, torch.bfloat16, (TRAIN_BATCH, 256, 320, 128) if not up else
                              (TRAIN_BATCH, 128, 160, 128), up, TAPS_DOWN_ASYM)
    g = torch.randn(want.shape, device=dev).to(torch.bfloat16)
    fn = fir_resample2x.fir_up2x if up else fir_resample2x.fir_down2x
    first = _grads(lambda t: fn(t, taps), (x,), g)[1]
    second = _grads(lambda t: fn(t, taps), (x,), g)[1]
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


def test_odd_fir_down_backward_raises(dev):
    """The backward of a down on an odd axis, which raised until the kernel
    had it: one launch of the up's "direct" variant with pads (2, 2) on the
    odd axis, against the plain up on the same gradient."""
    x = torch.randn((1, 9, 10, 64), device=dev, requires_grad=True)
    y = fir_resample2x.fir_down2x(x, TAPS_DOWN)
    g = torch.randn(y.shape, device=dev)
    _build.reset_counts()
    y.backward(g)
    torch.cuda.synchronize()
    assert dict(_build.backward_counts) == {"fir_up2x": 1}
    _close(x.grad, fir_resample2x.fir_up2x_plain(g, TAPS_DOWN[::-1], (1, 0)), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 7, 10, 8), (1, 8, 9, 8), (2, 63, 95, 64), (1, 127, 129, 6)])
def test_fir_down_backward_at_odd_sizes_matches_plain(dev, dtype, shape):
    x = torch.randn(shape, device=dev).to(dtype).requires_grad_()
    y = fir_resample2x.fir_down2x(x, TAPS_DOWN_ASYM)
    g = torch.randn(y.shape, device=dev).to(dtype)
    y.backward(g)
    assert x.grad.shape == shape
    extra = (shape[1] % 2, shape[2] % 2)
    assert fir_resample2x.plan_fir2x(*g.shape, dtype, True, True, extra).variant == "direct"
    _close(x.grad, fir_resample2x.fir_up2x_plain(g, TAPS_DOWN_ASYM[::-1], extra), dtype)


@pytest.mark.parametrize("up,k,factor,fmt", [(True, [1, 3, 3, 1], 4, "NHWC"),
                                             (False, [[1, 2, 1], [2, 4, 2], [1, 2, 1]], 2, "NHWC"),
                                             (True, [1, 3, 3, 1], 2, "NCHW"), (False, [1, 1], 2, "NHWC")])
def test_resampling_without_a_kernel_runs_plain_on_the_card(dev, up, k, factor, fmt):
    """What no kernel serves runs the plain upfirdn2d on the card, launching
    no kernel, and matches the CPU."""
    from diffsep_tpu_torch.ops import resampling

    fn = resampling.upsample_2d if up else resampling.downsample_2d
    x = torch.randn((2, 16, 24, 32) if fmt == "NHWC" else (2, 32, 16, 24))
    _build.reset_counts()
    got = fn(x.to(dev), k, factor=factor, data_format=fmt)
    torch.cuda.synchronize()
    assert not _build.launch_counts
    _close(got.cpu(), fn(x, k, factor=factor, data_format=fmt), torch.float32)


@pytest.mark.parametrize("predictor,corrector", [("reverse_diffusion", "ald2"), ("ddim", "none"),
                                                 ("dpmpp", "none")])
def test_prior_mix_sde_sampling_on_the_card_matches_the_cpu(dev, predictor, corrector):
    """The enhancement SDE's samplers with the same weights and draws, card
    (kernels) against CPU (plain versions), at 1e-3 of scale; and its
    float32 envelope over 3 s at 16 kHz, card against CPU, within 1e-4 of
    its maximum (the cumsum's summation order)."""
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.sampling import pc_sample
    from diffsep_tpu_torch.sde import PriorMixSDE

    cfg = dict(SMALL_F32, sde={"_target_": "PriorMixSDE", "N": 3})
    gpu = DiffSepModel(cfg, device=dev, seed=3)
    cpu = DiffSepModel(cfg, device="cpu", seed=3)
    assert isinstance(gpu.sde, PriorMixSDE)
    rng = np.random.default_rng(4)
    y = torch.from_numpy(rng.standard_normal((2, 1, 2000)).astype(np.float32))
    y[:, :, 500:1200] *= 0.01
    noise = _pc_noise(rng, (2, 2, 2000), 3)
    kw = dict(predictor_name=predictor, corrector_name=corrector, N=3, snr=0.3, noise=noise)
    with torch.no_grad():
        got, _ = pc_sample(gpu.sde, gpu.score_fn, y.to(dev), **kw)
        want, _ = pc_sample(cpu.sde, cpu.score_fn, y, **kw)
    assert (got.cpu() - want).abs().max() <= 1e-3 * want.abs().max()
    long = torch.from_numpy(rng.standard_normal((1, 1, 48000)).astype(np.float32))
    env_gpu, env_cpu = gpu.sde._std_sigma_mix(long.to(dev)).cpu(), cpu.sde._std_sigma_mix(long)
    assert (env_gpu - env_cpu).abs().max() <= 1e-4 * env_cpu.abs().max()


def test_small_model_train_step_on_the_card_matches_the_cpu(dev):
    """Two accumulated micro-steps (one optimizer step) of a small float32
    model from the same weights and draws: each micro-step's loss and
    gradient norm, and Adam's moments, card against CPU (the parameters
    themselves move by about +-lr wherever a gradient is nonzero, so a
    gradient near 0 can take either sign on either device)."""
    from diffsep_tpu_torch.model import DiffSepModel

    cfg = {"model": {"init_hack": 5, "init_hack_p": 0.5, "score_model": {"backbone_args": {
        "nf": 16, "ch_mult": (1, 2, 2), "num_res_blocks": 1, "attn_resolutions": (16,),
        "image_size": 64, "dtype": "float32"}, "stft_args": {"n_fft": 126, "hop_length": 32}}},
        "trainer": {"accumulate_grad_batches": 2}}
    rng = np.random.default_rng(0)
    b, n = 2, 2000
    tgt = torch.from_numpy(rng.standard_normal((b, 2, n)).astype(np.float32))
    mix = tgt.sum(dim=1, keepdim=True)
    draws = [{"mask": np.array(m, np.float32), "z0": rng.standard_normal((b, 2, n)).astype(np.float32),
              "z": rng.standard_normal((b, 2, n)).astype(np.float32),
              "shuffle": rng.uniform(size=(b, 2)).astype(np.float32),
              "time": rng.uniform(size=b).astype(np.float32)} for m in ([0.1, 0.9], [0.9, 0.2])]
    runs = {}
    for device in (dev, torch.device("cpu")):
        model = DiffSepModel(cfg, device=device, seed=3)
        state = model.init_state()
        step = model.make_train_step(seed=0)
        metrics = [step(state, mix.to(device), tgt.to(device), draws=d) for d in draws]
        runs[device.type] = dict(
            metrics=[{k: float(v) for k, v in m.items()} for m in metrics],
            mu=[t.cpu() for t in state.optimizer.mu], nu=[t.cpu() for t in state.optimizer.nu])
    card, cpu = runs["cuda"], runs["cpu"]
    for m_card, m_cpu in zip(card["metrics"], cpu["metrics"]):
        for key in ("train/score_loss", "grad/norm"):
            assert abs(m_card[key] - m_cpu[key]) <= 1e-3 * abs(m_cpu[key]), (key, m_card, m_cpu)
    for key in ("mu", "nu"):
        norm = torch.sqrt(sum((t.double() ** 2).sum() for t in cpu[key])).item()
        err = max((a - b_).abs().max().item() for a, b_ in zip(card[key], cpu[key]))
        assert err <= 1e-3 * norm, (key, err, norm)


def test_autoclip_and_schedules_on_the_card_match_the_cpu(dev):
    """AutoClip (its history on the card), linear warmup, the cosine decay
    and AdamW over four accumulated micro-steps of a small float32 model,
    card against CPU on the same weights and draws: each micro-step's loss,
    gradient norm, clipped norm and learning rate, AutoClip's history and
    count, and Adam's moments, within 1e-3 (relative, or of the norm)."""
    from diffsep_tpu_torch.model import DiffSepModel

    cfg = {"model": {"init_hack": 5, "init_hack_p": 0.5, "lr_warmup": 3,
                     "optimizer": {"lr": 1e-3, "weight_decay": 0.01},
                     "scheduler": {"_target_": "torch.optim.lr_scheduler.CosineAnnealingLR", "T_max": 10},
                     "grad_clipper": {"_target_": "AutoClipper", "p": 50.0},
                     "score_model": {"backbone_args": {"nf": 16, "ch_mult": (1, 2, 2), "num_res_blocks": 1,
                                                       "attn_resolutions": (16,), "image_size": 64,
                                                       "dtype": "float32"},
                                     "stft_args": {"n_fft": 126, "hop_length": 32}}},
           "trainer": {"accumulate_grad_batches": 2}}
    rng = np.random.default_rng(5)
    b, n = 2, 2000
    steps = []
    for m in ([0.1, 0.9], [0.9, 0.2], [0.3, 0.05], [0.7, 0.6]):
        tgt = torch.from_numpy(rng.standard_normal((b, 2, n)).astype(np.float32))
        steps.append((tgt.sum(dim=1, keepdim=True), tgt, {
            "mask": np.array(m, np.float32), "z0": rng.standard_normal((b, 2, n)).astype(np.float32),
            "z": rng.standard_normal((b, 2, n)).astype(np.float32),
            "shuffle": rng.uniform(size=(b, 2)).astype(np.float32), "time": rng.uniform(size=b).astype(np.float32)}))
    runs = {}
    for device in (dev, torch.device("cpu")):
        model = DiffSepModel(cfg, device=device, seed=3)
        assert model.optim_cfg.grad_clipper == "autoclip" and model.optim_cfg.scheduler == "cosine"
        state = model.init_state()
        step = model.make_train_step(seed=0)
        metrics = [step(state, mix.to(device), tgt.to(device), draws=d) for mix, tgt, d in steps]
        assert state.clip_state.history.device.type == device.type
        runs[device.type] = dict(
            metrics=[{k: float(v) for k, v in m.items()} for m in metrics],
            history=state.clip_state.history[:state.clip_state.count].cpu(), count=state.clip_state.count,
            mu=[t.cpu() for t in state.optimizer.mu], nu=[t.cpu() for t in state.optimizer.nu])
    card, cpu = runs["cuda"], runs["cpu"]
    assert card["count"] == cpu["count"] == 4
    assert torch.allclose(card["history"], cpu["history"], rtol=1e-3)
    for m_card, m_cpu in zip(card["metrics"], cpu["metrics"]):
        assert m_card["lr"] == m_cpu["lr"]
        for key in ("train/score_loss", "grad/norm", "grad/clipped_norm", "grad/step_size"):
            assert abs(m_card[key] - m_cpu[key]) <= 1e-3 * abs(m_cpu[key]), (key, m_card, m_cpu)
    for key in ("mu", "nu"):
        norm = torch.sqrt(sum((t.double() ** 2).sum() for t in cpu[key])).item()
        err = max((a - b_).abs().max().item() for a, b_ in zip(card[key], cpu[key]))
        assert err <= 1e-3 * norm, (key, err, norm)


# --- serving entry points ------------------------------------------------
SMALL_F32 = {"score_model": {"backbone_args": {
    "nf": 16, "ch_mult": (1, 2, 2), "num_res_blocks": 1, "attn_resolutions": (16,),
    "image_size": 64, "dtype": "float32"}, "stft_args": {"n_fft": 126, "hop_length": 32}}}
# (predictor, corrector, settings): the samplers beyond the production pair
SAMPLERS = [
    ("euler_maruyama", "none", {}), ("heun", "none", {}), ("dpmpp", "none", {"schedule": "log"}),
    ("reverse_diffusion", "langevin", {}), ("reverse_diffusion", "ald", {"corrector_steps": 2}),
    ("reverse_diffusion", "ald2", {"denoise": False}), ("euler_maruyama", "ald2", {"probability_flow": True}),
]


def _pc_noise(rng, shape, N, corrector_steps=1):
    def normal(*lead):
        return torch.from_numpy(rng.standard_normal(lead + shape).astype(np.float32))

    return {"prior": normal(), "corrector": normal(N, corrector_steps), "predictor": normal(N)}


@pytest.mark.parametrize("predictor,corrector,settings", SAMPLERS, ids=[f"{p}-{c}" for p, c, _ in SAMPLERS])
def test_new_samplers_on_the_card_match_the_cpu(dev, predictor, corrector, settings):
    """The same weights and draws through each sampler on the card (the
    kernels) and on the CPU (the plain versions), at 1e-3 of the output's
    scale, the card-vs-CPU bound of the score itself."""
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.sampling import pc_sample

    gpu = DiffSepModel(SMALL_F32, device=dev, seed=3)
    cpu = DiffSepModel(SMALL_F32, device="cpu", seed=3)
    rng = np.random.default_rng(1)
    y = torch.from_numpy(rng.standard_normal((2, 1, 2000)).astype(np.float32))
    N = 3
    noise = _pc_noise(rng, (2, 2, 2000), N, settings.get("corrector_steps", 1))
    kw = dict(predictor_name=predictor, corrector_name=corrector, N=N, snr=0.3, noise=noise, **settings)
    _build.reset_counts()
    with torch.no_grad():
        got, nfe = pc_sample(gpu.sde, gpu.score_fn, y.to(dev), **kw)
        torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
        want, _ = pc_sample(cpu.sde, cpu.score_fn, y, **kw)
    assert launches["conv3x3"] > 0 and launches["conv3x3"] % nfe == 0
    assert (got.cpu() - want).abs().max() <= 1e-3 * want.abs().max()


def test_ode_sample_on_the_card_matches_the_cpu(dev):
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.sampling import ode_sample

    gpu = DiffSepModel(SMALL_F32, device=dev, seed=3)
    cpu = DiffSepModel(SMALL_F32, device="cpu", seed=3)
    rng = np.random.default_rng(2)
    y = torch.from_numpy(rng.standard_normal((2, 1, 2000)).astype(np.float32))
    prior = torch.from_numpy(rng.standard_normal((2, 2, 2000)).astype(np.float32))
    with torch.no_grad():
        got, nfe = ode_sample(gpu.sde, gpu.score_fn, y.to(dev), N=2, prior=prior)
        want, _ = ode_sample(cpu.sde, cpu.score_fn, y, N=2, prior=prior)
    assert nfe == 9 and (got.cpu() - want).abs().max() <= 1e-3 * want.abs().max()


def test_engine_and_http_on_the_card(dev, tmp_path):
    """The serving engine on the card: micro-batches through the kernels,
    from the HTTP server's worker thread too (a thread of its own, where
    grad mode and the current device start from their defaults)."""
    import urllib.request

    from diffsep_tpu_torch.cli.serve import SeparationEngine
    from diffsep_tpu_torch.cli.serve_http import HTTPSeparationServer
    from diffsep_tpu_torch.data.audio_io import load_wav, load_wav_bytes, save_wav, wav_to_bytes
    from diffsep_tpu_torch.model import DiffSepModel

    model = DiffSepModel(SMALL_F32, device=dev, seed=3)
    eng = SeparationEngine(model, batch=2, sampler_kwargs={"N": 2})
    rng = np.random.default_rng(3)
    paths = []
    for i, n in enumerate((3000, 9000, 8500)):
        paths.append(tmp_path / f"m{i}.wav")
        save_wav(paths[-1], 0.1 * rng.standard_normal((1, n)).astype(np.float32), 8000)
    _build.reset_counts()
    assert all(ok for _, ok, _ in eng.process(paths, tmp_path / "out"))
    assert _build.launch_counts["conv3x3"] > 0 and eng.n_req == 2
    for p in paths:
        wav, _ = load_wav(tmp_path / "out" / "s1" / p.name)
        assert wav.shape == load_wav(p)[0].shape and np.isfinite(wav).all()
    body = wav_to_bytes(0.1 * rng.standard_normal((1, 4000)).astype(np.float32), 8000)
    with HTTPSeparationServer(eng, port=0) as srv:
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/v1/separate", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            est, sr = load_wav_bytes(resp.read())
    assert sr == 8000 and est.shape == (2, 4000) and np.isfinite(est).all()


# --- distillation and the export artifact --------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_ops_on_the_card_equal_the_kernel_calls(dev, dtype):
    """torch.ops.diffsep.* on CUDA tensors launch the kernels themselves: the
    same bits as the wrappers' kernel calls, one counted launch each."""
    x, k, bias = _conv_inputs(dev, dtype, (2, 16, 20, 64, 128))
    _build.reset_counts()
    got = torch.ops.diffsep.conv3x3(x, k, bias)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"conv3x3": 1}
    assert torch.equal(got, conv3x3._forward(x, k, bias))
    xf = torch.randn((2, 16, 20, 64), generator=torch.Generator(device=dev).manual_seed(1), device=dev).to(dtype)
    for op, args, up in ((torch.ops.diffsep.fir_down2x, (xf, TAPS_DOWN, False), False),
                         (torch.ops.diffsep.fir_up2x, (xf, tuple(2 * t for t in TAPS_DOWN), (0, 0), False), True)):
        _build.reset_counts()
        got = op(*args)
        torch.cuda.synchronize()
        assert dict(_build.launch_counts) == {"fir_up2x" if up else "fir_down2x": 1}
        assert torch.equal(got, fir_resample2x._resample(xf, args[1], up))


def test_exported_artifact_on_the_card_equals_the_live_model(dev, tmp_path):
    """An artifact exported on the card: the same estimates as the live
    separate_masked on the same seed, the kernels launched inside the
    exported program per evaluation as in the live model."""
    from diffsep_tpu_torch.export import export_separator, load_separator
    from diffsep_tpu_torch.model import DiffSepModel

    model = DiffSepModel(SMALL_F32, device=dev, seed=3)
    rng = np.random.default_rng(7)
    mix = (0.1 * rng.standard_normal((2, 1, 4000))).astype(np.float32)
    mix[1, :, 2500:] = 0.0
    n_valid = np.array([4000, 2500])
    kw = dict(N=2, predictor_name="reverse_diffusion", corrector_name="ald2")
    _build.reset_counts()
    want, nfe = model.separate_masked(mix, n_valid, generator=torch.Generator(device=dev).manual_seed(5), **kw)
    torch.cuda.synchronize()
    live = dict(_build.launch_counts)
    path = tmp_path / "small.dst"
    export_separator(model, 2, 4000, out_path=path, **kw)
    sep = load_separator(path)
    assert sep.meta["device"] == "cuda" and nfe == 4
    _build.reset_counts()
    got = sep.call(5, mix, n_valid)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == live and live["conv3x3"] > 0
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    with pytest.raises(ValueError, match="exported on cuda"):
        load_separator(path, device="cpu")


def test_distill_loss_gradients_on_the_card_match_the_cpu(dev):
    """distill_loss and the student's gradients of a small float32 model,
    card against CPU on the same draws (the on-policy and prior-at-T inputs
    included); the teacher takes no gradient on either."""
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.train.distill import DistillConfig, distill_loss, frozen_copy
    from diffsep_tpu_torch.train.losses import Draws

    b, n = 4, 2000
    rng = np.random.default_rng(8)
    tgt = torch.from_numpy(0.3 * rng.standard_normal((b, 2, n)).astype(np.float32))
    mix = tgt.sum(dim=1, keepdim=True)
    draws = {"i": np.array([0, 3, 1, 2]), "z": rng.standard_normal((b, 2, n)).astype(np.float32),
             "use_prior": np.array([0.2, 0.9, 0.1, 0.3], np.float32),
             "onpol_prior": rng.standard_normal((b, 2, n)).astype(np.float32),
             "use_onpol": np.array([0.1, 0.7, 0.9, 0.2], np.float32)}
    cfg = DistillConfig(n_student=4, on_policy_frac=0.5)
    res = {}
    for device in (dev, torch.device("cpu")):
        model = DiffSepModel(SMALL_F32, device=device, seed=3)
        teacher = frozen_copy(model.score_model)
        with torch.no_grad():
            for p in model.score_model.parameters():
                p.add_(0.01)
        loss = distill_loss(Draws(None, draws), model.sde, model.score_model, teacher, mix.to(device), tgt.to(device),
                            cfg)
        loss.backward()
        assert all(p.grad is None for p in teacher.parameters())
        res[device.type] = loss.item(), {k: p.grad.cpu() for k, p in model.score_model.named_parameters()
                                         if p.grad is not None}
    (l_card, g_card), (l_cpu, g_cpu) = res["cuda"], res["cpu"]
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in g_cpu.values())).item()
    assert abs(l_card - l_cpu) <= 1e-3 * abs(l_cpu)
    assert max((g_card[k] - g).abs().max().item() for k, g in g_cpu.items()) <= 1e-3 * norm


# --- data parallelism and multi-device evaluation -------------------------
@pytest.fixture
def one_rank_group(dev):
    """A one-rank NCCL process group on the card, for the length of a test."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        yield dist
    finally:
        dist.destroy_process_group()


def test_kernels_under_ddp_give_the_undistributed_gradients(one_rank_group, dev):
    """The training loss of a small float32 model through a one-rank DDP
    wrapper (conv and FIR kernels forward, the FIR kernels and cuDNN
    backward, the gradient through DDP's buckets) against the same loss
    without DDP, cuDNN deterministic: every parameter's gradient within
    1e-6 of the gradient norm, every kernel launched in both."""
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.train.losses import Draws
    from diffsep_tpu_torch.train.trainer import make_loss_fn

    model = DiffSepModel({"init_hack": 5, "init_hack_p": 0.5, **SMALL_F32}, device=dev, seed=3)
    rng = np.random.default_rng(2)
    b, n = 2, 2000
    tgt = torch.from_numpy(rng.standard_normal((b, 2, n)).astype(np.float32)).to(dev)
    mix = tgt.sum(dim=1, keepdim=True)
    draws = {"mask": np.array([0.1, 0.9], np.float32), "z0": rng.standard_normal((b, 2, n)).astype(np.float32),
             "z": rng.standard_normal((b, 2, n)).astype(np.float32),
             "shuffle": rng.uniform(size=(b, 2)).astype(np.float32), "time": rng.uniform(size=b).astype(np.float32)}
    ddp = torch.nn.parallel.DistributedDataParallel(model.score_model, device_ids=[dev.index or 0],
                                                    broadcast_buffers=False)
    grads, counts = {}, {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, fwd in (("ddp", ddp), ("plain", model.score_model)):
            model.score_model.zero_grad(set_to_none=True)
            _build.reset_counts()
            make_loss_fn(fwd, model.sde, model.loss_cfg)(Draws(None, draws), mix, tgt).backward()
            torch.cuda.synchronize()
            counts[name] = (dict(_build.launch_counts), dict(_build.backward_counts))
            grads[name] = {k: p.grad.clone() for k, p in model.score_model.named_parameters() if p.grad is not None}
    finally:
        torch.backends.cudnn.deterministic = saved
    assert grads["ddp"].keys() == grads["plain"].keys()
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads["plain"].values())).item()
    err = max((grads["ddp"][k] - g).abs().max().item() for k, g in grads["plain"].items())
    assert err <= 1e-6 * norm, (err, norm)
    assert counts["ddp"] == counts["plain"] and all(counts["ddp"][0].get(k, 0) > 0 for k in
                                                    ("conv3x3", "fir_down2x", "fir_up2x"))


def test_kernels_launch_on_every_card(dev):
    """The conv plans that need more than 48 KB of shared memory (wgmma, tma,
    tma_narrow: 129-193 KB) and the FIR tma plan launch on each visible card
    of one process in turn, each against its plain version: the
    shared-memory allowance is set per device. With one card this checks
    that card alone."""
    conv_shapes = [(2, 16, 20, 320, 256), (2, 128, 160, 256, 256), (1, 130, 131, 128, 6)]
    for index in range(torch.cuda.device_count()):
        card = torch.device("cuda", index)
        for shape in conv_shapes:
            x, k, bias = _conv_inputs(card, torch.bfloat16, shape)
            _close(conv3x3.conv3x3(x, k, bias), conv3x3.conv3x3_plain(x, k, bias), torch.bfloat16)
        for up in (False, True):
            x, taps, want = _fir_case(card, torch.bfloat16, (2, 128, 160, 128), up)
            assert fir_resample2x.plan_fir2x(*x.shape, torch.bfloat16, up, True).variant == "tma"
            got = (fir_resample2x.fir_up2x if up else fir_resample2x.fir_down2x)(x, taps)
            _close(got, want, torch.bfloat16)
        torch.cuda.synchronize(card)


def test_threaded_sharded_separate_launches_exactly(dev):
    """make_sharded_separate over two model copies (two cards where there
    are two, else one card twice), one thread each: the launches are twice
    one copy's on its half of the batch, exactly, and the estimates equal
    one call's on the same noise within 1e-4 of scale."""
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.parallel.shard_eval import make_sharded_separate

    devices = [0, 1] if torch.cuda.device_count() >= 2 else [0, 0]
    model = DiffSepModel(SMALL_F32, device=torch.device("cuda", devices[0]), seed=3)
    rng = np.random.default_rng(4)
    b, n, N = 4, 4000, 3
    mix = (0.3 * rng.standard_normal((b, 1, n))).astype(np.float32)
    noise = _pc_noise(rng, (b, 2, n), N)
    _build.reset_counts()
    want, nfe = model.separate(mix[:2], noise={"prior": noise["prior"][:2], "corrector": noise["corrector"][:, :, :2],
                                              "predictor": noise["predictor"][:, :2]}, N=N)
    torch.cuda.synchronize()
    one = dict(_build.launch_counts)
    run = make_sharded_separate(model, [torch.device("cuda", d) for d in devices], N=N)
    _build.reset_counts()
    got, got_nfe = run(mix, noise=noise)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {k: 2 * v for k, v in one.items()} and got_nfe == nfe == 2 * N
    assert (got[:2] - want.cpu()).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert torch.isfinite(got).all() and got.shape == (b, 2, n)


# --- the DiffuSE recipe and the library backbones (no hand kernel) --------
def _randomized_pair(make, dev, seed):
    """``make(device)`` twice, the CPU copy's weights replaced by seeded
    unit-scale values (the zero output projection included; scalars, the
    learnable transform constants, keep theirs) and copied to the card."""
    cpu = make("cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in cpu.parameters():
            if p.ndim == 0:
                continue
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=g) / (p.numel() / p.shape[0]) ** 0.5)
            else:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    gpu = make(dev)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def _forward_and_grads(module, inputs, w, device):
    module.zero_grad()
    out = module(*[x.to(device) for x in inputs])
    (out * w.to(device)).sum().backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu() for k, p in module.named_parameters()}
    return out.detach().cpu(), grads


def _card_vs_cpu(make, inputs, dev, seed):
    """(output error over its scale, max gradient error over the gradient
    norm) of the card against the CPU, in float32 with TF32 off."""
    cpu, gpu = _randomized_pair(make, dev, seed)
    with torch.no_grad():
        shape = cpu(*inputs).shape
    w = torch.randn(shape, generator=torch.Generator().manual_seed(seed + 1))
    out_c, g_c = _forward_and_grads(cpu, inputs, w, "cpu")
    out_g, g_g = _forward_and_grads(gpu, inputs, w, dev)
    norm = sum(float(g.double().square().sum()) for g in g_c.values()) ** 0.5
    return ((out_g - out_c).abs().max().item() / out_c.abs().max().item(),
            max(float((g_g[k] - g_c[k]).abs().max()) for k in g_c) / norm)


DIFFUSE_SMALL = ["model=diffuse", "model.score_model.backbone_args.residual_layers=10",
                 "model.score_model.backbone_args.residual_channels=32"]


def test_diffuse_score_and_gradients_on_the_card_match_the_cpu(dev):
    """DiffuSE (10 layers x 32 channels, a full dilation cycle) at 2 x 1 s,
    t = 1 included: within 1e-4 of the score's scale and 1e-3 of the
    gradient norm, and no hand kernel launched."""
    from diffsep_tpu_torch.config import compose
    from diffsep_tpu_torch.model import DiffSepModel

    cfg = compose(DIFFUSE_SMALL)
    g = torch.Generator().manual_seed(0)
    inputs = (torch.randn((2, 2, 8000), generator=g), torch.tensor([0.3, 1.0]), torch.randn((2, 1, 8000), generator=g))
    _build.reset_counts()
    score_err, grad_err = _card_vs_cpu(lambda d: DiffSepModel(cfg, device=d).score_model, inputs, dev, 1)
    assert score_err <= 1e-4 and grad_err <= 1e-3, (score_err, grad_err)
    assert not _build.launch_counts


@pytest.mark.parametrize("predictor,corrector", [("reverse_diffusion", "ald2"), ("ddim", "none")])
def test_diffuse_separate_on_the_card_matches_the_cpu(dev, predictor, corrector):
    """DiffSepModel.separate with the same draws on both devices, N=4:
    within 1e-3 of scale (the score's gap fed through the steps)."""
    from diffsep_tpu_torch.config import compose
    from diffsep_tpu_torch.model import DiffSepModel

    cfg = compose(DIFFUSE_SMALL)
    cpu, gpu = _randomized_pair(lambda d: DiffSepModel(cfg, device=d), dev, 2)
    g = torch.Generator().manual_seed(3)
    mix = 0.3 * torch.randn((2, 1, 8000), generator=g)
    noise = {"prior": torch.randn((2, 2, 8000), generator=g), "corrector": torch.randn((4, 1, 2, 2, 8000), generator=g),
             "predictor": torch.randn((4, 2, 2, 8000), generator=g)}
    kw = dict(predictor_name=predictor, corrector_name=corrector, N=4)
    want, _ = cpu.separate(mix, noise=noise, **kw)
    _build.reset_counts()
    got, _ = gpu.separate(mix, noise=noise, **kw)
    assert not _build.launch_counts
    assert (got.cpu() - want).abs().max().item() <= 1e-3 * want.abs().max().item()


AUX_CASES = [("tcn", "gLN", False), ("tcn", "cLN", True), ("tcn", "BN", False), ("dptnet", "LSTM", True),
             ("dptnet", "GRU", False), ("dptnet", "RNN", True)]


@pytest.mark.parametrize("family,variant,flag", AUX_CASES, ids=["-".join(map(str, c)) for c in AUX_CASES])
def test_aux_models_on_the_card_match_the_cpu(dev, family, variant, flag):
    """TemporalConvNet (norm, causal) and DPTNet (RNN, bidirectional), small:
    within 1e-4 of the output's scale and 1e-3 of the gradient norm."""
    from diffsep_tpu_torch.models import DPTNet, TemporalConvNet

    g = torch.Generator().manual_seed(4)
    if family == "tcn":
        make = lambda d: TemporalConvNet(N=32, B=16, H=32, P=3, X=3, R=2, C=2, norm_type=variant,  # noqa: E731
                                         causal=flag).to(d)
        inputs = (torch.randn((2, 32, 200), generator=g),)
    else:
        # train mode (dropout 0: the same function): cuDNN's RNN backward
        # runs only in training mode
        make = lambda d: DPTNet(variant, 16, 24, 8, att_heads=4, num_layers=2, bidirectional=flag).to(d)  # noqa: E731
        inputs = (torch.randn((2, 16, 20, 8), generator=g),)
    out_err, grad_err = _card_vs_cpu(make, inputs, dev, 5)
    assert out_err <= 1e-4 and grad_err <= 1e-3, (out_err, grad_err)


# --- the NCSN++ options ----------------------------------------------------
# chip_smoke.py's option sets A-D (backbone_args, frontend) over the flagship
OPTION_SETS = {
    "A": ({"fir": False, "progressive": "none", "progressive_input": "none", "embedding_type": "positional",
           "scale_by_sigma": False}, {"transform": "log", "spec_factor": 3.0}),
    "B": ({"progressive_input": "residual"}, {"spec_trans_learnable": True}),
    "C": ({"resblock_type": "ddpm", "progressive": "residual", "progressive_input": "input_skip",
           "progressive_combine": "cat", "centered": True}, {"transform": "none", "stft_args": {"center": False}}),
    "D": ({"resblock_type": "ddpm", "fir": False, "progressive": "none", "progressive_input": "none",
           "conditional": False, "nonlinearity": "elu", "skip_rescale": False}, {}),
}
OPTION_PER_EVAL = {"A": {"conv3x3": 100}, "B": {"conv3x3": 106, "fir_down2x": 12, "fir_up2x": 18},
                   "C": {"conv3x3": 77, "fir_down2x": 6}, "D": {"conv3x3": 82}}


def _option_config(name, **backbone):
    bb, frontend = OPTION_SETS[name]
    frontend = dict(frontend)
    return {"score_model": {"backbone_args": dict(bb, **backbone), "stft_args": frontend.pop("stft_args", {}),
                            **frontend}}


@pytest.mark.parametrize("name", sorted(OPTION_SETS))
def test_option_set_kernel_calls_match_plain(dev, name):
    """One full-width evaluation of an option set (bf16 compute, where the
    JAX package's promotions leave some layers in f32): its launches per
    evaluation, and every conv and FIR call it makes against the plain
    version on the same input."""
    from unittest import mock

    from diffsep_tpu_torch.model import DiffSepModel

    model = DiffSepModel(_option_config(name), device=dev, seed=0)
    calls = []
    real = {"conv3x3": conv3x3.conv3x3, "fir_down2x": fir_resample2x.fir_down2x,
            "fir_up2x": fir_resample2x.fir_up2x}
    plain = {"conv3x3": conv3x3.conv3x3_plain, "fir_down2x": fir_resample2x.fir_down2x_plain,
             "fir_up2x": fir_resample2x.fir_up2x_plain}

    def recorder(kind):
        def call(x, *args):
            y = real[kind](x, *args)
            calls.append((kind, x, args, y))
            return y
        return call

    g = torch.Generator(device=dev).manual_seed(1)
    xt, mix = torch.randn((2, 2, 40000), generator=g, device=dev), torch.randn((2, 1, 40000), generator=g, device=dev)
    _build.reset_counts()
    with mock.patch.object(conv3x3, "conv3x3", recorder("conv3x3")), \
            mock.patch.object(fir_resample2x, "fir_down2x", recorder("fir_down2x")), \
            mock.patch.object(fir_resample2x, "fir_up2x", recorder("fir_up2x")), torch.no_grad():
        score = model.score_fn(0.3 * xt, torch.tensor([0.4, 0.9], device=dev), 0.3 * mix)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.launch_counts.items() if v} == OPTION_PER_EVAL[name]
    assert torch.isfinite(score).all()
    for kind, x, args, y in calls:
        _close(y, plain[kind](x, *args), x.dtype)


@pytest.mark.parametrize("name", sorted(OPTION_SETS))
def test_option_set_on_the_card_matches_the_cpu(dev, name):
    """Each option set at nf=16 in float32, 2 x 1 s: the score within 1e-3
    of its scale and the parameter gradients (the learnable transform
    constants included) within 1e-3 of their norm, card against CPU."""
    from diffsep_tpu_torch.model import DiffSepModel

    cfg = _option_config(name, nf=16, ch_mult=(1, 1, 2, 2), num_res_blocks=1, dtype="float32")
    g = torch.Generator().manual_seed(2)
    inputs = (0.3 * torch.randn((2, 2, 8000), generator=g), torch.tensor([0.4, 0.9]),
              0.3 * torch.randn((2, 1, 8000), generator=g))
    _build.reset_counts()
    score_err, grad_err = _card_vs_cpu(lambda d: DiffSepModel(cfg, device=d).score_model, inputs, dev, 3)
    assert score_err <= 1e-3 and grad_err <= 1e-3, (score_err, grad_err)
    assert _build.launch_counts["conv3x3"] > 0


@pytest.mark.parametrize("name", ["B", "C"])
def test_remat_gradients_on_the_card_equal_no_remat(dev, name):
    """remat recomputes each residual and attention block in the backward,
    which launches their kernels again; the gradients are those without it
    (nf=16, float32, cuDNN deterministic), within 1e-6 of their norm."""
    from diffsep_tpu_torch.model import DiffSepModel

    cfg = _option_config(name, nf=16, ch_mult=(1, 1, 2, 2), num_res_blocks=1, dtype="float32", remat=True)
    _, model = _randomized_pair(lambda d: DiffSepModel(cfg, device=d).score_model, dev, 4)
    g = torch.Generator().manual_seed(5)
    inputs = (0.3 * torch.randn((2, 2, 8000), generator=g), torch.tensor([0.4, 0.9]),
              0.3 * torch.randn((2, 1, 8000), generator=g))
    w = torch.randn((2, 2, 8000), generator=g)
    out, counts = {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (True, False):
            model.backbone.remat = remat
            _build.reset_counts()
            out[remat] = _forward_and_grads(model, inputs, w, dev)
            torch.cuda.synchronize()
            counts[remat] = _build.launch_counts["conv3x3"] - _build.backward_counts["conv3x3"]
    finally:
        torch.backends.cudnn.deterministic = False
    (_, g_r), (_, g_n) = out[True], out[False]
    norm = sum(float(v.double().square().sum()) for v in g_n.values()) ** 0.5
    assert max(float((g_r[k] - g_n[k]).abs().max()) for k in g_n) <= 1e-6 * norm
    assert counts[False] < counts[True] < 2 * counts[False], counts


# --- FSDP, tensor parallelism and three speakers ---------------------------
# The flagship's convs with their output channels split over tp = 2 and 4
# (each rank runs Cout / tp: the trunk's 128 and 256 at 64/32 and 128/64,
# the output pyramid's 6 at 3; at tp = 4 it stays whole), and the
# three-speaker stem (Cin = 8) and output pyramid (Cout = 8), at batch 1 of
# 5 s.
TP_AND_3SPK_SHAPES = [(1, 256, 320, 128, 64), (1, 256, 320, 128, 32), (1, 128, 160, 128, 64),
                      (1, 64, 80, 256, 128), (1, 32, 40, 256, 64), (1, 16, 20, 256, 64), (1, 4, 5, 256, 128),
                      (1, 256, 320, 128, 3), (1, 128, 160, 128, 3), (1, 256, 320, 8, 128), (1, 256, 320, 128, 8),
                      (1, 8, 10, 256, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TP_AND_3SPK_SHAPES)
def test_conv3x3_at_the_tp_and_three_speaker_shapes_matches_plain(dev, dtype, shape):
    x, k, bias = _conv_inputs(dev, dtype, shape)
    n0 = _build.launch_counts["conv3x3"]
    got = conv3x3.conv3x3(x, k, bias)
    torch.cuda.synchronize()
    assert _build.launch_counts["conv3x3"] == n0 + 1
    _close(got, conv3x3.conv3x3_plain(x, k, bias), dtype)


def test_tp_split_conv_equals_the_columns_of_the_whole_conv(dev):
    """A rank's conv at Cout / 2 gives the whole conv's columns of its half
    (the tensor-parallel layer's all-gather then rebuilds the whole output),
    within the kernels' bf16 tolerance."""
    x, k, bias = _conv_inputs(dev, torch.bfloat16, (1, 64, 80, 256, 256))
    whole = conv3x3.conv3x3(x, k, bias)
    halves = [conv3x3.conv3x3(x, k[..., i * 128:(i + 1) * 128].contiguous(), bias[i * 128:(i + 1) * 128])
              for i in range(2)]
    _close(torch.cat(halves, dim=-1), whole, torch.bfloat16)


def test_fsdp_validation_after_a_step_on_the_card(one_rank_group, dev):
    """The weight-cache hazard of FSDP on the card: a small model sharded by
    ``mesh.shard_fsdp`` over a one-rank group separates with its EMA
    weights (filling the convs' weight caches), takes two optimizer steps,
    and separates again: equal within 1e-5 of scale to a one-process model
    that holds the same EMA weights, and different from the first
    separation."""
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.parallel import mesh
    from diffsep_tpu_torch.train import loop, trainer
    from diffsep_tpu_torch.train.ema import swapped

    cfg = {"init_hack": 5, "init_hack_p": 0.5, "optimizer": {"lr": 1e-3}, **SMALL_F32}
    model = DiffSepModel(cfg, device=dev, seed=3)
    state = model.init_state()
    trainer.shard_state(state, mesh.shard_fsdp(model.score_model, state.names, min_size=64))
    assert not any(getattr(m, "keep_weight_copy", False) for m in model.score_model.modules())
    rng = np.random.default_rng(4)
    mix = torch.from_numpy(0.3 * rng.standard_normal((1, 1, 2000)).astype(np.float32))
    kw = dict(predictor_name="ddim", corrector_name="none", N=2, schedule="log")

    def separate():
        with swapped(state.ema, state.params):
            return model.separate(mix, generator=torch.Generator(device=dev).manual_seed(0), **kw)[0]

    before = separate()
    step = model.make_train_step(seed=0, forward=model.score_model)
    for _ in range(2):
        tgt = torch.from_numpy(0.2 * rng.standard_normal((2, 2, 2000)).astype(np.float32)).to(dev)
        step(state, tgt.sum(dim=1, keepdim=True), tgt)
    after = separate()
    ema = state.state_dict()["ema"]["params"]
    ref = DiffSepModel(cfg, device=dev, seed=3)
    ref.score_model.load_state_dict({**loop.whole_model_state(model, state), **ema}, strict=True)
    want = ref.separate(mix, generator=torch.Generator(device=dev).manual_seed(0), **kw)[0]
    scale = want.abs().max().item()
    assert (after - want).abs().max().item() <= 1e-5 * scale
    assert (after - before).abs().max().item() > 1e-4 * scale


# The legacy blocks (models/legacy_layers.py) at NCSNv2's width (ngf 128)
# on the flagship's top grid: the conv shapes they give the hand kernel in
# float32 (the second MSF/Refine input at 128 x 160 x 256)
LEGACY_F32_SHAPES = [(2, 256, 320, 128, 128), (2, 128, 160, 256, 128), (2, 128, 160, 256, 256),
                     (2, 256, 320, 128, 256), (2, 128, 160, 128, 256), (2, 256, 320, 256, 256)]


@pytest.mark.parametrize("shape", LEGACY_F32_SHAPES)
def test_conv3x3_at_the_legacy_shapes_matches_plain(dev, shape):
    x, k, bias = _conv_inputs(dev, torch.float32, shape)
    _close(conv3x3.conv3x3(x, k, bias), conv3x3.conv3x3_plain(x, k, bias), torch.float32)


def _legacy_cases():
    import torch.nn.functional as F

    from diffsep_tpu_torch.models import legacy_layers as L
    from diffsep_tpu_torch.models import normalization as N

    c, cin = 32, N.ConditionalInstanceNorm2dPlus
    return {
        "CRPBlock": (lambda: L.CRPBlock(c, 2), "x", 2),
        "CondRefineBlock": (lambda: L.CondRefineBlock([c, 2 * c], c, 5, cin), "pair", 14),
        "ConvMeanPool adjust_padding": (lambda: L.ConvMeanPool(c, 2 * c, adjust_padding=True), "odd", 1),
        "UpsampleConv": (lambda: L.UpsampleConv(c, c), "half", 1),
        "ResidualBlock down": (lambda: L.ResidualBlock(c, 2 * c, resample="down"), "x", 2),
        "ResidualBlock dilation 2": (lambda: L.ResidualBlock(c, 2 * c, dilation=2), "x", 0),
        "ConditionalResidualBlock batch norm": (
            lambda: L.ConditionalResidualBlock(c, c, 5, normalization=N.ConditionalBatchNorm2d), "xy", 2),
        "ResnetBlockDDPM": (lambda: L.ResnetBlockDDPM(F.silu, c, 2 * c, temb_dim=64), "temb", 2),
    }


@pytest.mark.parametrize("name", ["CRPBlock", "CondRefineBlock", "ConvMeanPool adjust_padding", "UpsampleConv",
                                  "ResidualBlock down", "ResidualBlock dilation 2",
                                  "ConditionalResidualBlock batch norm", "ResnetBlockDDPM"])
def test_legacy_block_on_the_card_matches_plain_and_the_cpu(dev, name):
    """A legacy block at 32 channels on 16 x 20: one conv3x3 launch per 3x3
    stride-1 undilated conv (none for the dilated ones), the kernels within
    1e-4 of the plain versions on the card, the card within 1e-3 of the
    CPU (float32, TF32 off)."""
    from unittest import mock

    make, kind, convs = _legacy_cases()[name]
    torch.manual_seed(7)
    cpu = make().eval()
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(0.1 * torch.randn(p.shape))
    gpu = make().eval().to(dev)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(8)
    x = torch.randn((2, 16, 20, 32), generator=g)
    y = torch.tensor([0, 4])
    inputs = {"x": (x,), "xy": (x, y), "odd": (x[:, :15, :19],), "half": (x[:, :8, :10],),
              "temb": (x, torch.randn((2, 64), generator=g)),
              "pair": ([x, torch.randn((2, 8, 10, 64), generator=g)], y, (16, 20))}[kind]

    def on(d):
        return [[t.to(d) for t in a] if isinstance(a, list) else a.to(d) if torch.is_tensor(a) else a
                for a in inputs]

    with torch.no_grad():
        want = cpu(*inputs)
        n0 = _build.launch_counts["conv3x3"]
        got = gpu(*on(dev))
        assert _build.launch_counts["conv3x3"] - n0 == convs
        with mock.patch.object(conv3x3, "conv3x3", conv3x3.conv3x3_plain):
            plain = gpu(*on(dev))
    _close(got, plain, torch.float32)
    scale = want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() <= 1e-3 * scale
