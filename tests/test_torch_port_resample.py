"""diffsep_tpu_torch FIR resampling vs diffsep_tpu (CPU, float32).

The port's plain FIR 2x up/down (the CPU path of the resampling kernels)
is held against the JAX package's upsample_2d/downsample_2d through the
XLA conv reference (impl="conv"), at the NCSN++ channel counts including
C=6 and odd widths, and through the Pallas kernels in interpret mode
(impl="pallas") on the shapes those kernels take. Both sides sum at most
16 float32 products per output: atol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsep_tpu.ops.resampling as jres
from diffsep_tpu.ops.upfirdn2d import upfirdn2d as jax_upfirdn2d
from diffsep_tpu_torch.ops import fir_resample2x, resampling, upfirdn2d

FIR = [1.0, 3.0, 3.0, 1.0]
ATOL = 1e-5


@pytest.mark.parametrize(
    "shape",
    [(2, 8, 10, 6), (1, 16, 5, 6), (2, 4, 5, 128), (1, 7, 9, 3), (1, 8, 16, 256)],
)
@pytest.mark.parametrize("direction", ["up", "down"])
def test_fir_resample_matches_conv_reference(rng, shape, direction):
    x = rng.standard_normal(shape).astype(np.float32)
    jfn = jres.upsample_2d if direction == "up" else jres.downsample_2d
    tfn = resampling.upsample_2d if direction == "up" else resampling.downsample_2d
    want = np.asarray(jfn(jnp.asarray(x), FIR, factor=2, impl="conv", data_format="NHWC"))
    got = tfn(torch.from_numpy(x), FIR, factor=2, data_format="NHWC").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("direction", ["up", "down"])
def test_fir_resample_matches_pallas_interpret(rng, direction):
    x = rng.standard_normal((2, 8, 16, 128)).astype(np.float32)
    jfn = jres.upsample_2d if direction == "up" else jres.downsample_2d
    tfn = fir_resample2x.fir_up2x if direction == "up" else fir_resample2x.fir_down2x
    want = np.asarray(jfn(jnp.asarray(x), FIR, factor=2, impl="pallas", data_format="NHWC"))
    taps = np.asarray(FIR) / 8.0 * (2.0 if direction == "up" else 1.0)
    got = tfn(torch.from_numpy(x), tuple(taps)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_asymmetric_taps_follow_the_kernel_flip(rng):
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    k = [1.0, 2.0, 4.0, 1.0]
    for jfn, tfn in [(jres.downsample_2d, resampling.downsample_2d),
                     (jres.upsample_2d, resampling.upsample_2d)]:
        want = np.asarray(jfn(jnp.asarray(x), k, impl="conv", data_format="NHWC"))
        got = tfn(torch.from_numpy(x), k, data_format="NHWC").numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize(
    "up,down,pad", [(3, 1, (1, 1)), (1, 3, (2, 0)), (2, 2, (1, 2)), (1, 1, (-1, 2))]
)
def test_general_upfirdn2d_matches(rng, up, down, pad):
    x = rng.standard_normal((2, 3, 9, 7)).astype(np.float32)
    k = np.outer([1.0, 2.0, 1.0], [1.0, 3.0, 1.0]).astype(np.float32)
    want = np.asarray(jax_upfirdn2d(jnp.asarray(x), k, up=up, down=down, pad=pad, impl="conv"))
    got = upfirdn2d.upfirdn2d(torch.from_numpy(x), k, up=up, down=down, pad=pad).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_setup_kernel_matches():
    for k in ([1, 3, 3, 1], [1, 2, 1], np.ones((3, 3))):
        np.testing.assert_allclose(resampling.setup_kernel(k), jres.setup_kernel(k), rtol=1e-7)
