"""Gradients through the kernel wrappers, on the CPU, where they run the
plain versions in forward while their backward is the one the card runs:
the framework conv's for conv3x3, the other FIR direction with reversed
taps and the adjoint pads for the FIR pair. ``torch.autograd.gradcheck``
holds each to finite differences in float64 (its default tolerances)."""
import numpy as np
import pytest
import torch

from diffsep_tpu_torch.models import layers
from diffsep_tpu_torch.ops import _build, conv3x3, fir_resample2x, resampling
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

TAPS_ASYM = (0.125, 0.25, 0.5, 0.125)


def _rand(*shape, grad=True):
    g = torch.Generator().manual_seed(sum(shape))
    return torch.randn(shape, generator=g, dtype=torch.float64).requires_grad_(grad)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("x_grad", [True, False])
def test_conv3x3_gradcheck(bias, x_grad):
    x, w = _rand(1, 4, 5, 2, grad=x_grad), _rand(3, 3, 2, 3)
    b = _rand(3) if bias else None
    assert torch.autograd.gradcheck(conv3x3.conv3x3, (x, w, b))


@pytest.mark.parametrize("shape", [(2, 6, 8, 3), (1, 4, 10, 5)])
@pytest.mark.parametrize("up", [False, True])
def test_fir_gradcheck(shape, up):
    taps = tuple(2 * t for t in TAPS_ASYM) if up else TAPS_ASYM
    fn = fir_resample2x.fir_up2x if up else fir_resample2x.fir_down2x
    assert torch.autograd.gradcheck(lambda x: fn(x, taps), (_rand(*shape),))


def test_fir_up_gradcheck_at_odd_sizes():
    assert torch.autograd.gradcheck(lambda x: fir_resample2x.fir_up2x(x, TAPS_ASYM), (_rand(1, 5, 3, 2),))


@pytest.mark.parametrize("shape", [(1, 5, 6, 2), (1, 6, 7, 2), (1, 7, 5, 2)])
def test_fir_down_backward_raises_at_odd_sizes(shape):
    """The backward of a down on an odd axis, which raised until it had its
    adjoint (an up with pads (2, 2) there, 2 m + 1 long): now it holds to
    finite differences like the even sizes."""
    assert torch.autograd.gradcheck(lambda x: fir_resample2x.fir_down2x(x, TAPS_ASYM), (_rand(*shape),))


def test_backward_counts_nothing_on_the_cpu():
    """Counts are for kernel launches, and the CPU runs none."""
    _build.reset_counts()
    x = _rand(1, 8, 8, 4)
    resampling.downsample_2d(resampling.upsample_2d(x, (1, 3, 3, 1), data_format="NHWC"),
                             (1, 3, 3, 1), data_format="NHWC").sum().backward()
    assert not _build.launch_counts


def test_conv_layer_weight_gets_its_gradient():
    """In grad mode the HWIO copy is differentiable (dW reaches the OIHW
    parameter); without it the cached copy serves and is refreshed after an
    optimizer-style in-place update."""
    torch.manual_seed(0)
    conv = layers.conv3x3(3, 5)
    conv.reset_parameters()
    x = torch.randn(2, 6, 7, 3)
    conv(x).square().sum().backward()
    want_w, = torch.autograd.grad(
        torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, padding=1).square().sum(),
        conv.weight)
    assert torch.allclose(conv.weight.grad, want_w, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        first = conv._kernel_weight(torch.float32)
        assert conv._kernel_weight(torch.float32) is first
        conv.weight.add_(1.0)
        assert not torch.equal(conv._kernel_weight(torch.float32), first)


def test_model_gradients_match_the_plain_route():
    """A tiny NCSN++ score: parameter gradients through the Functions
    against autograd of the plain versions (the same arithmetic in forward,
    other kernels in backward), within 1e-5 of the gradient norm."""
    from unittest import mock

    from diffsep_tpu_torch.model import DiffSepModel
    from _torch_port_util import PORT_TINY_CONFIG

    model = DiffSepModel(PORT_TINY_CONFIG, device="cpu", seed=2)
    rng = np.random.default_rng(0)
    xt, mix = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in ((2, 2, 900), (2, 1, 900)))
    t = torch.tensor([0.3, 0.9])

    def grads():
        model.score_model.zero_grad(set_to_none=True)
        model.score_fn(xt, t, mix).square().mean().backward()
        return {k: p.grad.clone() for k, p in model.score_model.named_parameters() if p.grad is not None}

    got = grads()
    with mock.patch.object(conv3x3, "conv3x3", conv3x3.conv3x3_plain), \
            mock.patch.object(fir_resample2x, "fir_down2x", fir_resample2x.fir_down2x_plain), \
            mock.patch.object(fir_resample2x, "fir_up2x", fir_resample2x.fir_up2x_plain):
        want = grads()
    assert got.keys() == want.keys() and len(got) > 50
    norm = torch.sqrt(sum((g ** 2).sum() for g in want.values()))
    assert max((got[k] - want[k]).abs().max() for k in want) <= 1e-5 * norm
