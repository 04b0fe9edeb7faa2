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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape", [(2, 16, 20, 6, 128), (1, 9, 7, 128, 6), (2, 8, 10, 256, 128), (1, 4, 5, 512, 256),
              (1, 3, 70, 40, 72)],
)
def test_conv3x3_kernel_matches_plain(dev, dtype, shape):
    b, h, w, ci, co = shape
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((b, h, w, ci), generator=g, device=dev).to(dtype)
    k = (torch.randn((3, 3, ci, co), generator=g, device=dev) / (9 * ci) ** 0.5).to(dtype)
    bias = torch.randn((co,), generator=g, device=dev).to(dtype)
    n0 = _build.launch_counts["conv3x3"]
    got = conv3x3.conv3x3(x, k, bias)
    torch.cuda.synchronize()
    assert _build.launch_counts["conv3x3"] == n0 + 1
    assert got.dtype == dtype and got.shape == (b, h, w, co)
    _close(got, conv3x3.conv3x3_plain(x, k, bias), dtype)
    _close(conv3x3.conv3x3(x, k), conv3x3.conv3x3_plain(x, k), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape", [(2, 16, 20, 6), (1, 8, 10, 128), (2, 5, 5, 256), (1, 7, 9, 3), (1, 32, 40, 96),
              (1, 16, 20, 16), (2, 12, 14, 40)],
)
@pytest.mark.parametrize("up", [False, True])
@pytest.mark.parametrize("down_taps", [TAPS_DOWN, TAPS_DOWN_ASYM], ids=["sym", "asym"])
def test_fir_kernels_match_plain(dev, dtype, shape, up, down_taps):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    name = "fir_up2x" if up else "fir_down2x"
    fn = fir_resample2x.fir_up2x if up else fir_resample2x.fir_down2x
    plain = fir_resample2x.fir_up2x_plain if up else fir_resample2x.fir_down2x_plain
    taps = tuple(2 * t for t in down_taps) if up else down_taps
    n0 = _build.launch_counts[name]
    got = fn(x, taps)
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == n0 + 1
    want = plain(x, taps)
    assert got.shape == want.shape and got.dtype == dtype
    _close(got, want, dtype)


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
