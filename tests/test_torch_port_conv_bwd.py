"""The float32 backward of diffsep_tpu_torch's 3x3 conv, checked on the CPU:
its plain versions (ops/conv3x3.conv3x3_dx_plain, conv3x3_dw_plain) against
the JAX package's gradients (jax.vjp of conv3x3_reference, and conv3x3_mxu's
custom VJP with its Pallas forward), the operand layouts the kernels read
(dx's flipped split weight, dw's split dy, the "window" dw's walk), the
arithmetic of three TF32 products against float64, the dw kernels' orders
of summation at their longest walks, and the planner's routes for dx and
dw. The kernels themselves run on the card only
(tests/test_torch_port_cuda.py).

Tolerances, of the largest |gradient|: 1e-5 between float32 sums of the
same terms in other orders (dw sums up to 640 pixels here, and the
emulated kernel orders up to 140 800); three TF32 products within 1e-5 of
the float64 dw, one alone off by more than 1e-4; the "window" walk in
float64 within 1e-12 of the float64 plain dw (the same exact terms).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsep_tpu.ops.pallas.conv3x3 import conv3x3_mxu, conv3x3_reference
from diffsep_tpu_torch.ops import conv3x3 as conv_mod
from test_torch_port_conv import FLAGSHIP_CONVS
from test_torch_port_conv_f32 import _im2col, _kernel_a_operand
from test_torch_port_conv_narrow_cin import _frozen

TOL = 1e-5
GRIDS = [(4, 5), (7, 6), (16, 20)]
CHANNELS = [(6, 32), (32, 64), (64, 32), (96, 4), (128, 128)]


def _case(rng, b, h, w, cin, cout):
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    dy = rng.standard_normal((b, h, w, cout)).astype(np.float32)
    return x, k, dy


def _assert_close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("hw", GRIDS, ids=lambda v: f"{v[0]}x{v[1]}")
@pytest.mark.parametrize("channels", CHANNELS, ids=lambda v: f"{v[0]}-{v[1]}")
def test_plain_dx_dw_match_jax_vjp(rng, hw, channels):
    """conv3x3_dx_plain and conv3x3_dw_plain, the CPU op's backward (the
    framework conv's), and the CPU routes of conv3x3_dx and conv3x3_dw, all
    against jax.vjp of conv3x3_reference."""
    x, k, dy = _case(rng, 2, *hw, *channels)
    _, vjp = jax.vjp(conv3x3_reference, jnp.asarray(x), jnp.asarray(k))
    gx, gk = vjp(jnp.asarray(dy))
    xt, kt, dyt = (torch.from_numpy(a) for a in (x, k, dy))
    _assert_close(conv_mod.conv3x3_dx_plain(dyt, kt), gx)
    _assert_close(conv_mod.conv3x3_dw_plain(xt, dyt), gk)
    _assert_close(conv_mod.conv3x3_dx(dyt, kt), gx)
    _assert_close(conv_mod.conv3x3_dw(xt, dyt), gk)
    leaves = [xt.clone().requires_grad_(), kt.clone().requires_grad_()]
    op_dx, op_dw = torch.autograd.grad(conv_mod.conv3x3(*leaves), leaves, dyt)
    _assert_close(op_dx, gx)
    _assert_close(op_dw, gk)


def test_plain_dx_dw_match_the_pallas_conv_custom_vjp(rng):
    """Against the VJP of conv3x3_mxu (the JAX package's Pallas forward with
    XLA's backward), the gradient the port's kernels replace."""
    x, k, dy = _case(rng, 2, 7, 6, 32, 64)
    _, vjp = jax.vjp(conv3x3_mxu, jnp.asarray(x), jnp.asarray(k))
    gx, gk = vjp(jnp.asarray(dy))
    xt, kt, dyt = (torch.from_numpy(a) for a in (x, k, dy))
    _assert_close(conv_mod.conv3x3_dx_plain(dyt, kt), gx)
    _assert_close(conv_mod.conv3x3_dw_plain(xt, dyt), gk)


def test_dx_split_weight_meets_the_forward_kernel_registers(rng):
    """dx's operand, the split of the flipped, transposed weight (what the
    split kernel makes with its flip), against the tf32x3 forward kernel's
    A fragments of dy gives dx."""
    x, k, dy = _case(rng, 1, 5, 6, 96, 64)
    kt, dyt = torch.from_numpy(k), torch.from_numpy(dy)
    split = conv_mod.tf32_split_weight(kt, flip=True)  # the CPU route: the plain version
    assert split.shape == (2, 96, 9 * 64)
    assert split.equal(conv_mod.tf32_split_weight_plain(conv_mod.conv3x3_dx_weight(kt)))
    got = _kernel_a_operand(_im2col(dyt)).double() @ (split[0].double() + split[1].double()).T
    want = conv_mod.conv3x3_dx_plain(dyt.double(), kt.double())
    _assert_close(got.reshape(want.shape).numpy(), want.numpy())


def _dw_a_operand(x):
    """dw's A operand as the kernel's registers hold it, (9 Cin, K): row
    (tap, ci) is the tap's shifted view of channel ci; per 32-pixel slice,
    the thread of column group t puts pixel 8 t + 2 kk + (r >> 1) into
    register r of k8 step kk, which the tf32 layout reads as column t + 4
    (r >> 1) of the step."""
    taps = [v.reshape(-1, v.shape[-1]).T for v in conv_mod._shifted(x)]
    a = torch.cat(taps)  # (9 Cin, M)
    k = -(-a.shape[1] // 32) * 32
    a = torch.nn.functional.pad(a, (0, k - a.shape[1]))
    out = torch.empty_like(a)
    for s in range(k // 32):
        for kk in range(4):
            for t in range(4):
                for half in range(2):
                    out[:, 32 * s + 8 * kk + t + 4 * half] = a[:, 32 * s + 8 * t + 2 * kk + half]
    return out


def test_dw_split_dy_meets_the_dw_kernel_registers(rng):
    """dy split as the dw kernel's pass writes it ((2, Cout, K), K the pixels
    padded to 32, permuted per slice) against the A fragments of the
    shifted x gives dw."""
    x, _, dy = _case(rng, 2, 7, 6, 32, 64)  # 84 pixels: three slices, the last one ragged
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    split = conv_mod.tf32_split_rows_plain(dyt.reshape(-1, 64), 96)
    col = np.arange(32)
    past = 64 + col[8 * (col % 8 % 4) + 2 * (col // 8) + col % 8 // 4 >= 20]  # the last slice's pixels 84..95
    assert split.shape == (2, 64, 96) and len(past) == 12 and not split[:, :, past].any()
    got = _dw_a_operand(xt).double() @ (split[0].double() + split[1].double()).T
    want = conv_mod.conv3x3_dw_plain(xt.double(), dyt.double())
    _assert_close(got.reshape(want.shape).numpy(), want.numpy())


def test_three_tf32_products_keep_the_dw_float32_accurate(rng):
    """The emulated "tf32x3" dw within 1e-5 of scale of the float64 one at
    16 x 20 x 2 pixels and 128 -> 64 channels; one TF32 product (hi.hi)
    alone misses by more than 1e-4, so the card's tolerance would catch a
    kernel that dropped the correction terms."""
    x, _, dy = _case(rng, 2, 16, 20, 128, 64)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    want = conv_mod.conv3x3_dw_plain(xt.double(), dyt.double())
    scale = want.abs().max().item()
    three = conv_mod.tf32x3_dw_emulated(xt, dyt)
    assert (three - want).abs().max().item() <= 1e-5 * scale
    one = torch.stack([conv_mod.tf32_round(v.reshape(-1, 128)).double().T
                       @ conv_mod.tf32_round(dyt.reshape(-1, 64)).double() for v in conv_mod._shifted(xt)])
    assert (one.reshape(want.shape) - want).abs().max().item() > 1e-4 * scale


def _micro_step_shapes():
    """(b, h, w, cin, cout) of every conv of the f32 + remat micro-step (the
    flagship at batch 6) and of option sets B, C and D at batch 2 (every
    conv shape of the sets, their f32 ones among them)."""
    flagship = [(6, *s[1:], c) for s, c in FLAGSHIP_CONVS]
    options = sorted({key[:5] for key, _ in _frozen()["options"] if key[0] == 2})
    return flagship + [s for s in options if s not in flagship]


@pytest.mark.parametrize("shape", _micro_step_shapes(), ids=lambda s: "x".join(map(str, s)))
def test_backward_routes_at_the_micro_step_shapes(shape):
    """dx of (b, h, w, cin) -> cout runs the forward planner's plan for
    (b, h, w, cout) -> cin: "tf32x3" where cout % 32 == 0 and cin is a
    multiple of 64 or below 64, else "generic"; a "tf32x3" one split so that
    no split walks more than DX_MAX_SLICES slices. dw takes an instantiated
    plan: "window" where a side has at most WINDOW_NARROW channels (the
    stem's Cin 6, the output convs' Cout 6), its blocks of 32 wide channels
    x 8 columns over strips of rows (as few as give WINDOW_BLOCKS blocks, at
    most one a row), its partials one tile a block; else "tf32x3" where
    both channel counts are multiples of 32, else "generic". A "tf32x3" or
    "generic" plan's splits walk every 32-pixel slice once, at least
    DW_MIN_SLICES each ("tf32x3" walks whole chains of slices), within
    DW_WAVES waves of the blocks the card holds, so its partials stay within
    DW_WAVES x DW_RESIDENT x bm x bn floats, and a "tf32x3" block fits shared
    memory."""
    b, h, w, cin, cout = shape
    fwd, dx = conv_mod.plan_conv3x3(b, h, w, cout, cin, torch.float32), conv_mod.plan_conv3x3_dx(b, h, w, cin, cout)
    assert dx.variant == fwd.variant == ("tf32x3" if cout % 32 == 0 and (cin % 64 == 0 or cin < 64) else "generic")
    assert (dx.bm, dx.bn, dx.stages, dx.grid[:2]) == (fwd.bm, fwd.bn, fwd.stages, fwd.grid[:2])
    assert dx.splits == (max(fwd.splits, -(-9 * cout // 32 // conv_mod.DX_MAX_SLICES)) if dx.variant == "tf32x3"
                         else fwd.splits) and dx.grid[2] == dx.splits
    dw = conv_mod.plan_conv3x3_dw(b, h, w, cin, cout)
    want = ("window" if min(cin, cout) <= conv_mod.WINDOW_NARROW else "tf32x3" if cin % 32 == 0 and cout % 32 == 0
            else "generic")
    assert dw.variant == want and (dw.variant, dw.bm, dw.bn) in conv_mod.DW_INSTANCES
    if want == "window":
        chunks, per_strip = -(-max(cin, cout) // 32), b * -(-w // 8)
        strips = dw.splits // per_strip
        assert dw.bn == min(cin, cout) + min(cin, cout) % 2 and dw.splits == per_strip * strips
        assert dw.grid == (chunks, 1, dw.splits) and 1 <= strips <= h
        assert chunks * dw.splits >= conv_mod.WINDOW_BLOCKS or strips == h
        assert strips == 1 or chunks * per_strip * (strips - 1) < conv_mod.WINDOW_BLOCKS  # as few as that takes
        return
    assert dw.bn == (64 if want == "generic" else max(n for n in (32, 64, 128) if cout % n == 0))
    rows, k_tiles = 9 * cin, -(-b * h * w // 32)
    tiles = -(-rows // dw.bm) * -(-cout // dw.bn)
    assert dw.grid == (-(-rows // dw.bm), -(-cout // dw.bn), dw.splits)
    unit = conv_mod.DW_CHAIN if want == "tf32x3" else 1  # "tf32x3" walks whole chains of slices
    units = -(-k_tiles // unit)
    ranges = [(z * units // dw.splits, (z + 1) * units // dw.splits) for z in range(dw.splits)]
    assert dw.splits == 1 or all(unit * (e - a) >= conv_mod.DW_MIN_SLICES for a, e in ranges)
    resident = conv_mod.DW_RESIDENT[dw.variant]
    assert dw.splits == 1 or tiles * dw.splits <= conv_mod.DW_WAVES * resident
    assert dw.splits * rows * cout <= conv_mod.DW_WAVES * resident * dw.bm * dw.bn  # the workspace bound
    assert dw.smem_bytes <= conv_mod.SMEM_LIMIT
    if tiles * conv_mod.DW_MIN_SLICES * 2 <= k_tiles:  # long walks split to fill the card
        assert tiles * dw.splits > resident // 2


def test_unaligned_dw_takes_the_generic_plan():
    assert conv_mod.plan_conv3x3_dw(6, 64, 80, 128, 128).variant == "tf32x3"
    assert conv_mod.plan_conv3x3_dw(6, 64, 80, 128, 128, False).variant == "generic"


@pytest.mark.parametrize("shape", [(6, 256, 320, 128, 128), (2, 16, 20, 6, 32), (6, 64, 80, 256, 6),
                                   (1, 9, 7, 64, 20), (1, 3, 4, 7, 5)])
def test_dw_launch_passes_the_plan(monkeypatch, shape):
    """The weight-gradient wrapper hands the C entry point its plan,
    argument for argument, with the scratch it needs: dy's split copy (2,
    Cout, pixels rounded up to whole chains of slices) for "tf32x3", the
    partials (splits, 9 Cin, Cout) where it splits ("window" blocks each write one, "tf32x3" and
    "generic" splits of the pixels); and counts one backward launch of
    conv3x3_dw. The entry point and the stream are stand-ins here."""
    import types

    calls, counted = [], []
    monkeypatch.setattr(conv_mod._build, "entry", lambda lib, name, argtypes: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(conv_mod._build, "count_launch", lambda *a, **k: counted.append((a, k)))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    b, h, w, cin, cout = shape
    plan = conv_mod.plan_conv3x3_dw(*shape)
    x, dy = torch.zeros((b, h, w, cin)), torch.zeros((b, h, w, cout))
    out = torch.empty((3, 3, cin, cout))
    assert conv_mod._launch_dw(x, dy, out, plan) is out
    (args,) = calls
    kp = -(-b * h * w // (32 * conv_mod.DW_CHAIN)) * 32 * conv_mod.DW_CHAIN  # whole chains of 32-pixel slices
    assert len(args) == len(conv_mod._DW_ARGTYPES)
    assert args[5:14] == (b, h, w, cin, cout, conv_mod._VARIANTS[plan.variant], plan.bn, plan.splits, kp)
    assert (args[2] is None) == (plan.variant != "tf32x3") and (args[4] is None) == (plan.splits == 1)
    assert counted == [(("conv3x3_dw", x.shape, cout), {"backward": True, "plan": plan.variant})]


@pytest.mark.parametrize("shape", [(2, 7, 13, 40, 6), (2, 7, 13, 6, 40), (1, 5, 9, 7, 5), (2, 6, 11, 33, 3),
                                   (1, 4, 16, 64, 8)], ids=lambda s: "x".join(map(str, s)))
def test_window_dw_walk_meets_the_plain_dw(rng, shape):
    """The "window" kernel's walk (window_dw_emulated in float64, at the
    plan's strips): the window positions as taps, swapped sides (the stem's
    Cin < Cout), ragged columns and channel blocks, an odd narrow side, the
    blocks' partials in order, against the float64 plain dw."""
    b, h, w, cin, cout = shape
    x, _, dy = _case(rng, *shape)
    plan = conv_mod.plan_conv3x3_dw(*shape)
    assert plan.variant == "window"
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    got = conv_mod.window_dw_emulated(xt, dyt, plan.splits // (b * -(-w // 8)))
    want = conv_mod.conv3x3_dw_plain(xt.double(), dyt.double())
    assert (got - want).abs().max().item() <= 1e-12 * want.abs().max().item()


def _longest_walks():
    """The longest walk of each dw plan at the micro-step shapes: "tf32x3"'s
    32-pixel slices of one split (whole chains of DW_CHAIN), and "window"'s
    rows of one strip."""
    walks = {"tf32x3": 0, "window": 0}
    for b, h, w, cin, cout in _micro_step_shapes():
        plan = conv_mod.plan_conv3x3_dw(b, h, w, cin, cout)
        if plan.variant == "tf32x3":
            chains = -(-b * h * w // (32 * conv_mod.DW_CHAIN))
            walks["tf32x3"] = max(walks["tf32x3"], conv_mod.DW_CHAIN * -(-chains // plan.splits))
        elif plan.variant == "window":
            walks["window"] = max(walks["window"], -(-h // (plan.splits // (b * -(-w // 8)))))
    return walks


def test_tf32x3_dw_order_keeps_float32_accuracy_at_the_longest_walk(rng):
    """"tf32x3"'s order of summation (tf32x3_dw_emulated with splits: each
    chain of DW_CHAIN slices' wgmma rounded once to float32, promoted chain
    by chain into a float32 sum, the partials summed in order) within 1e-5
    of the float64 dw over two splits of the longest walk a split takes at
    the micro-step's shapes (6 x 256 x 320 x 256 -> 128 in 7 splits: 2196
    slices); few channels: the walk, not the width, sets the error."""
    walk = _longest_walks()["tf32x3"]
    assert walk >= 2000
    b, h, w = 1, 2 * walk, 32  # two splits of `walk` slices of 32 pixels
    x, _, dy = _case(rng, b, h, w, 8, 8)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    want = conv_mod.conv3x3_dw_plain(xt.double(), dyt.double())
    got = conv_mod.tf32x3_dw_emulated(xt, dyt, splits=2)
    assert got.dtype == torch.float32
    assert (got.double() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("swap", [False, True], ids=["output_conv", "stem"])
def test_window_dw_order_keeps_float32_accuracy_at_the_longest_walk(rng, swap):
    """"window"'s order in float32 (window_dw_emulated: row by row down a
    column, the block's columns in order, the partials in order) within
    1e-5 of the float64 dw, a strip as long as the longest the micro-step's
    plans take (256 rows at 256 x 320), for the output convs' sides and the
    stem's."""
    rows = _longest_walks()["window"]
    assert rows == 256
    cin, cout = (6, 32) if swap else (32, 6)
    x, _, dy = _case(rng, 1, rows, 16, cin, cout)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    want = conv_mod.conv3x3_dw_plain(xt.double(), dyt.double())
    got = conv_mod.window_dw_emulated(xt, dyt, 1, torch.float32)
    assert (got.double() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_bwd_sums_hold_each_dw_plan_to_cudnn_on_its_own_shapes():
    """chip_smoke.bwd_sums, which phase 12 prints and the `kernels` line
    carries: dw summed over each shape's launches per micro-step, by plan
    and by group, the "window" dw apart for the output convs (Cout <= 8) and
    the stem (Cin <= 8), each group with its cuDNN time and bound."""
    import chip_smoke

    def row(shape, cout, variant, n, ms, lib):
        return dict(part="dw", shape=list(shape), cout=cout, plan=dict(variant=variant), launches_per_micro_step=n,
                    ms=ms, plain_ms=2 * ms, library_ms=lib, bound_ms=ms / 4, bound_ffma_ms=ms / 2,
                    bound_3xtf32_ms=ms / 4, ops_ms=ms / 4, bytes_ms=ms / 8, rel_err=1e-6)

    rows = [row((6, 256, 320, 128), 128, "tf32x3", 9, 2.0, 2.5), row((6, 64, 80, 256), 256, "tf32x3", 8, 0.5, 0.4),
            row((6, 256, 320, 128), 6, "window", 1, 0.3, 1.6), row((6, 32, 40, 256), 6, "window", 1, 0.04, 0.05),
            row((6, 256, 320, 6), 128, "window", 1, 0.6, 1.6)]
    dx = dict(rows[0], part="dx")
    dw = chip_smoke.bwd_sums(rows + [dx])["dw"]
    assert dw["launches"] == 20 and dw["ms_by_plan"] == pytest.approx({"tf32x3": 22.0, "window": 0.94})
    assert dw["by_group"] == {
        "tf32x3": dict(launches=17, ms=pytest.approx(22.0), library_ms=pytest.approx(25.7),
                       bound_ms=pytest.approx(5.5)),
        "window, Cout <= 8": dict(launches=2, ms=pytest.approx(0.34), library_ms=pytest.approx(1.65),
                                  bound_ms=pytest.approx(0.085)),
        "window, Cin <= 8": dict(launches=1, ms=pytest.approx(0.6), library_ms=pytest.approx(1.6),
                                 bound_ms=pytest.approx(0.15))}
    assert dw["ms"] == pytest.approx(22.94) and dw["library_ms"] == pytest.approx(28.95)
