"""Repairs of the port, each against the JAX package where it has a
counterpart (CPU, float32):

* the backward of a FIR down on an odd axis (an up with pads (2, 2) there)
  against ``jax.grad`` of the JAX package's ``downsample_2d``, within 1e-5
  (both sum at most 16 float32 products per element);
* resampling that no kernel serves (factor 4, a 2-D filter, NCHW) runs the
  plain ``upfirdn2d`` and matches the JAX package's XLA convolution, within
  1e-5, values and gradients;
* the error messages name the ROADMAP's current items;
* an installed copy carries the kernels' header and the yaml tree.
"""
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsep_tpu.ops.resampling as jres
from diffsep_tpu_torch.cli import separate as separate_cli
from diffsep_tpu_torch.ops import fir_resample2x, resampling
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
FIR = [1.0, 3.0, 3.0, 1.0]
ATOL = 1e-5


def _grad_pair(jfn, tfn, x, g):
    """(port value, port x-gradient), (JAX value, JAX x-gradient) of
    sum(f(x) * g)."""
    want, vjp = jax.vjp(jfn, jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = tfn(xt)
    got.backward(torch.from_numpy(g))
    return (got.detach().numpy(), xt.grad.numpy()), (np.asarray(want), np.asarray(want_g))


@pytest.mark.parametrize("shape", [(1, 7, 10, 8), (1, 8, 9, 8), (2, 9, 7, 6), (1, 5, 5, 3)])
def test_odd_fir_down_backward_matches_jax_grad(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal((shape[0], shape[1] // 2, shape[2] // 2, shape[3])).astype(np.float32)
    got, want = _grad_pair(
        lambda v: jres.downsample_2d(v, FIR, factor=2, impl="conv", data_format="NHWC"),
        lambda v: resampling.downsample_2d(v, FIR, factor=2, data_format="NHWC"), x, g)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=ATOL)
    assert got[1].shape == shape


def test_odd_up_plain_is_the_adjoint_pads():
    """fir_up2x_plain's extra row and column: the pads (2, 2) upfirdn2d,
    2 m + 1 long, whose first 2 m agree with the (2, 1) up."""
    g = torch.randn(1, 3, 4, 2)
    out = fir_resample2x.fir_up2x_plain(g, (0.25, 0.75, 0.75, 0.25), (1, 1))
    assert out.shape == (1, 7, 9, 2)
    torch.testing.assert_close(out[:, :6, :8], fir_resample2x.fir_up2x_plain(g, (0.25, 0.75, 0.75, 0.25)))
    plan = fir_resample2x.plan_fir2x(1, 3, 4, 64, torch.bfloat16, True, True, (1, 0))
    assert plan.variant == "direct" and plan.vec == 1


@pytest.mark.parametrize("up,k,factor,fmt,shape", [
    (True, FIR, 4, "NHWC", (2, 6, 5, 4)),
    (False, FIR, 4, "NHWC", (2, 16, 12, 4)),
    (True, [[1, 2, 1], [2, 4, 2], [1, 2, 1]], 2, "NHWC", (1, 5, 6, 3)),
    (False, [[1, 2, 1], [2, 4, 2], [1, 2, 1]], 2, "NHWC", (1, 10, 12, 3)),
    (True, FIR, 2, "NCHW", (2, 3, 5, 6)),
    (False, [1, 1], 2, "NCHW", (2, 3, 8, 6)),
])
def test_resampling_without_a_kernel_matches_jax(rng, up, k, factor, fmt, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    jfn = jres.upsample_2d if up else jres.downsample_2d
    tfn = resampling.upsample_2d if up else resampling.downsample_2d
    out_shape = jax.eval_shape(lambda v: jfn(v, k, factor=factor, impl="conv", data_format=fmt),
                               jnp.asarray(x)).shape
    g = rng.standard_normal(out_shape).astype(np.float32)
    got, want = _grad_pair(lambda v: jfn(v, k, factor=factor, impl="conv", data_format=fmt),
                           lambda v: tfn(v, k, factor=factor, data_format=fmt), x, g)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=ATOL)


def test_messages_name_the_current_roadmap_items(tmp_path):
    artifact = tmp_path / "model.dsexp"
    artifact.write_bytes(separate_cli.ARTIFACT_MAGIC + b"...")
    with pytest.raises(NotImplementedError, match="queue 1 item 4, the export artifact"):
        separate_cli.reject_artifact(artifact)
    roadmap = (ROOT / "ROADMAP.md").read_text()
    assert "4. **The export artifact.**" in roadmap
    for path in (ROOT / "diffsep_tpu_torch").rglob("*.py"):
        assert "Remaining, in order" not in path.read_text(), path


def test_package_data_has_the_kernel_header_and_the_yaml_tree():
    data = tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"]["setuptools"]["package-data"]
    port = ROOT / "diffsep_tpu_torch"
    shipped = {p for pattern in data["diffsep_tpu_torch"] for p in port.glob(pattern)}
    shipped |= {p for pattern in data["diffsep_tpu_torch.config"] for p in (port / "config").glob(pattern)}
    assert port / "csrc" / "hopper.cuh" in shipped
    needed = set((port / "csrc").glob("*.cu")) | set((port / "config" / "yaml").rglob("*.yaml"))
    assert needed <= shipped
    assert port / "config" / "yaml" / "experiment" / "noise-reduction.yaml" in shipped
