"""Hand-written CUDA kernels vs their plain PyTorch versions, on the card.

Marked `cuda`: every test skips where no CUDA device is present. They
import neither JAX nor the JAX package and use no conftest fixture, so
they run on a machine with the card and without JAX:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Tolerances, of max(1, |plain|): float32 kernels accumulate in float32 like
the plain versions (cuDNN with TF32 off), so they agree to 1e-4 (measured
<= 1.6e-5 for the conv's 9 * Cin terms, <= 5e-7 for the FIR). bfloat16
outputs are each rounded once from an f32 sum on both sides; they differ
by at most about one bf16 step, held to 1e-2.
"""
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
# both sides sum the same terms in float32 (the conv's backward is cuDNN's
# on both routes) and round once to the working type.
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
    for (b, h, w, ci), co in _shapes(training_launches[0], "conv3x3"):
        x, k, bias = _conv_inputs(dev, dtype, (b, h, w, ci, co))
        g = torch.randn((b, h, w, co), device=dev).to(dtype)
        n0 = _build.launch_counts["conv3x3"]
        got = _grads(conv3x3.conv3x3, (x, k, bias), g)
        assert _build.launch_counts["conv3x3"] == n0 + 1
        want = _grads(conv3x3.conv3x3_plain, (x, k, bias), g)
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
    x = torch.randn((1, 9, 10, 64), device=dev, requires_grad=True)
    y = fir_resample2x.fir_down2x(x, TAPS_DOWN)
    with pytest.raises(NotImplementedError, match="odd-sized"):
        y.sum().backward()


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
