"""diffsep_tpu_torch 3x3 conv (its CPU path, the plain version) vs
diffsep_tpu's conv3x3_reference (XLA) and its Pallas kernel in interpret
mode (CPU, float32). Each output sums 9 * Cin float32 products; atol 1e-4
on unit-scale inputs with 0.1-scale weights, as tests/test_pallas_conv.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsep_tpu.ops.pallas.conv3x3 import _conv3x3_pallas, conv3x3_reference
from diffsep_tpu_torch.models.layers import Conv
from diffsep_tpu_torch.ops.conv3x3 import conv3x3

ATOL = 1e-4


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
    """The HWIO copy is made once per weight version: a second call reuses
    it, a load_state_dict (in-place copy) replaces it."""
    conv = Conv(4, 8, 3)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.standard_normal((1, 6, 7, 4)).astype(np.float32))
    y0 = conv(x)
    cached = conv._hwio[1]
    conv(x)
    assert conv._hwio[1] is cached
    w = torch.from_numpy(rng.standard_normal((8, 4, 3, 3)).astype(np.float32))
    conv.load_state_dict({"weight": w, "bias": torch.zeros(8)})
    y1 = conv(x)
    assert conv._hwio[1] is not cached
    want = conv3x3_reference(jnp.asarray(x.numpy()), jnp.asarray(w.numpy().transpose(2, 3, 1, 0)))
    np.testing.assert_allclose(y1.detach().numpy(), np.asarray(want), atol=ATOL)
    assert not torch.allclose(y0, y1)
