"""The port's utilities (utils/*, ops/fused_act.py) against the JAX
package's, on the CPU in float32: StandardScaler and solve_psd_loaded
within 1e-5 of scale, parameter counts exactly, bn_update on a block
holding two ConditionalBatchNorm2d within 1e-5 of the statistics' scale,
fused_leaky_relu and its gradient within 1e-6; and the pure-Python helpers
(registry, imports, split directories, pools, the package's exports)."""
from __future__ import annotations

import warnings

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import diffsep_tpu.utils as jutils
import diffsep_tpu_torch.utils as putils
from diffsep_tpu.models import normalization as JN
from diffsep_tpu.ops import fused_act as jfused
from diffsep_tpu.utils.bn_update import bn_update as jax_bn_update
from diffsep_tpu.utils.params import count_parameters as jax_count_parameters
from diffsep_tpu_torch.models import normalization as PN
from diffsep_tpu_torch.models.convert import legacy_state_dict_from_jax
from diffsep_tpu_torch.ops import fused_act as pfused
from diffsep_tpu_torch.utils.bn_update import bn_update
from diffsep_tpu_torch.utils.params import count_parameters, to_device

TOL = 1e-5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def test_exports_match_the_jax_package():
    assert set(putils.__all__) == set(jutils.__all__)
    for name in putils.__all__:
        assert getattr(putils, name) is not None
    from diffsep_tpu_torch.train import clippers

    assert putils.FixedClipper is clippers.FixedClipper and putils.grad_norm is clippers.grad_norm
    with pytest.raises(AttributeError):
        putils.missing_name


@pytest.mark.parametrize("dims", [None, (0, 1)])
def test_standard_scaler_matches_jax(dims):
    rng = np.random.default_rng(0)
    data = (rng.standard_normal((40, 3, 7)) * 3.0 + 1.5).astype(np.float32)
    if dims is None:
        data = data.reshape(120, 7)
    js, ps = jutils.StandardScaler((7,), dims=dims), putils.StandardScaler((7,), dims=dims)
    jst, pst = js.init(), ps.init()
    for chunk in np.split(data, 5):
        jst = js.update(jst, jnp.asarray(chunk))
        pst = ps.update(pst, torch.from_numpy(chunk))
    assert isinstance(pst, putils.ScalerState)
    for got, want in zip(pst, jst):
        _close(got, want)
    _close(ps.std(pst), js.std(jst))
    _close(ps.scale(pst, torch.from_numpy(data)), js.scale(jst, jnp.asarray(data)))
    _close(ps.unscale(pst, torch.from_numpy(data)), js.unscale(jst, jnp.asarray(data)))
    flat = data.reshape(-1, 7)
    _close(pst.mean, flat.mean(0))
    _close(ps.std(pst), flat.std(0, ddof=1), 1e-4)


@pytest.mark.parametrize("matrix_rhs", [False, True])
def test_solve_psd_loaded_matches_jax(matrix_rhs):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 5, 5))
    A = (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(5)).astype(np.float32)
    b = rng.standard_normal((3, 5, 2) if matrix_rhs else (3, 5)).astype(np.float32)
    want = np.asarray(jutils.solve_psd_loaded(jnp.asarray(A), jnp.asarray(b)))
    got = putils.solve_psd_loaded(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    _close(got, want, 1e-4)
    back = A @ (got if matrix_rhs else got[..., None])
    _close(back if matrix_rhs else back[..., 0], b, 1e-3)


def test_count_parameters_and_to_device():
    tree = {"a": np.zeros((3, 4), np.float32), "b": [np.zeros(5, np.float32), {"c": np.zeros((2, 2, 2))}]}
    ttree = {"a": torch.zeros(3, 4), "b": [torch.zeros(5), {"c": torch.zeros(2, 2, 2)}]}
    assert count_parameters(ttree) == jax_count_parameters(tree) == 25
    mod = nn.Linear(4, 3)
    mod.bias.requires_grad_(False)
    assert count_parameters(mod) == 12 and count_parameters(mod, trainable_only=False) == 15
    state = putils.ScalerState(torch.zeros(()), torch.zeros(2), torch.ones(2))
    moved = to_device({"s": state, "l": [torch.ones(1), 3], "t": (torch.ones(2),)}, "meta")
    assert isinstance(moved["s"], putils.ScalerState) and moved["s"].m2.device.type == "meta"
    assert moved["l"][0].is_meta and moved["l"][1] == 3 and moved["t"][0].is_meta


class JaxTwoNorms(fnn.Module):
    """Two conditional batch norms around a ReLU, labelled by row index."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        y = jnp.arange(x.shape[0]) % 3
        h = JN.ConditionalBatchNorm2d(4, 3, name="norm1")(x, y, train=train)
        return JN.ConditionalBatchNorm2d(4, 3, name="norm2")(jax.nn.relu(h), y, train=train)


class PortTwoNorms(nn.Module):
    def __init__(self):
        super().__init__()
        self.norm1, self.norm2 = PN.ConditionalBatchNorm2d(4, 3), PN.ConditionalBatchNorm2d(4, 3)

    def forward(self, x):
        y = torch.arange(x.shape[0]) % 3
        return self.norm2(torch.relu(self.norm1(x, y)), y)


def test_bn_update_matches_jax():
    """Both set the running statistics to the batch-size-weighted mean of
    the per-batch statistics (the unbiased variance). The JAX module folds
    each batch's statistics into the old ones with momentum 0.1; the
    adapter below hands JAX's bn_update the batch's own, as the reference's
    SWA loop reads them."""
    rng = np.random.default_rng(2)
    loader = [rng.standard_normal((b, 5, 6, 4)).astype(np.float32) * (1 + i) + i
              for i, b in enumerate((3, 2, 5))]
    jmod = JaxTwoNorms()
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(loader[0]))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.1, variables["params"])
    stats = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.5, variables["batch_stats"])

    def apply_fn(v, x, mutable):
        out, upd = jmod.apply(v, x, train=True, mutable=mutable)
        own = jax.tree_util.tree_map(lambda u, o: (u - 0.9 * o) / 0.1, upd["batch_stats"], v["batch_stats"])
        return out, {"batch_stats": own}

    want = jax_bn_update(loader, apply_fn, {"params": params, "batch_stats": stats})["batch_stats"]
    pmod = PortTwoNorms()
    pmod.load_state_dict(legacy_state_dict_from_jax(params, stats), strict=True)
    pmod.eval()
    assert bn_update(loader, pmod) is pmod and not pmod.training
    for name in ("norm1", "norm2"):
        bn = getattr(pmod, name).bn
        _close(bn.running_mean, want[name]["bn"]["mean"])
        _close(bn.running_var, want[name]["bn"]["var"])
        assert bn.momentum == 0.1
    # norm1 sees the data itself: the weighted mean of its batch means is
    # the mean over all rows
    _close(pmod.norm1.bn.running_mean, np.concatenate(loader).mean(axis=(0, 1, 2)))


def test_bn_update_without_batch_norm_reads_nothing():
    def loader():
        raise AssertionError("read")
        yield

    mod = nn.Linear(2, 2)
    assert bn_update(loader(), mod) is mod


@pytest.mark.parametrize("bias,slope,scale", [(True, 0.2, 2.0**0.5), (False, 0.1, 1.0), (True, 0.0, 3.0)])
def test_fused_leaky_relu_matches_jax(bias, slope, scale):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4, 3)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32) if bias else None
    want = jfused.fused_leaky_relu(jnp.asarray(x), None if b is None else jnp.asarray(b), slope, scale)
    xt = torch.from_numpy(x).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_() if bias else None
    got = pfused.fused_leaky_relu(xt, bt, slope, scale)
    _close(got.detach(), want, 1e-6)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(xj, bj):
        return (jfused.fused_leaky_relu(xj, bj, slope, scale) * w).sum()

    gx, gb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), None if b is None else jnp.asarray(b))
    (got * torch.from_numpy(w)).sum().backward()
    _close(xt.grad, gx, 1e-6)
    if bias:
        _close(bt.grad, gb, 1e-6)
    module = pfused.FusedLeakyReLU(torch.from_numpy(b) if bias else torch.zeros(5), slope, scale)
    jmod = jfused.FusedLeakyReLU(jnp.asarray(b) if bias else jnp.zeros(5), slope, scale)
    with torch.no_grad():
        _close(module(torch.from_numpy(x)), jmod(jnp.asarray(x)), 1e-6)
    assert [n for n, _ in module.named_parameters()] == ["bias"]


def test_registry_imports_and_split_directory(tmp_path):
    reg = putils.Registry("thing")
    reg.register("a")(int)
    assert reg.get_by_name("a") is int and "a" in reg and list(reg) == ["a"] and len(reg) == 1
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        reg.register("a")(float)
    assert caught and reg.get_all_names() == ["a"]
    with pytest.raises(ValueError, match="Available"):
        reg.get_by_name("b")
    assert putils.import_name("diffsep_tpu_torch.utils.solve_psd_loaded") is putils.solve_psd_loaded
    with pytest.raises(ImportError):
        putils.import_name("nodots")
    assert putils.module_from_config("collections.Counter", "aab")["a"] == 2
    cfg = {"name": "builtins.max", "args": [3], "kwargs": {}}
    assert putils.run_configured_func(cfg, 7, 5) == 7
    sd = putils.SplitDirectory(tmp_path, max_files=2)
    paths = [sd / f"f{i}.wav" for i in range(5)]
    assert [p.parent.name for p in paths] == ["0000", "0000", "0001", "0001", "0002"]


def test_processing_pools_keep_order_and_errors():
    def fail():
        raise RuntimeError("boom")

    with putils.ProcessingPool(2) as pool:
        for i in range(3):
            pool.push(pow, i, 2)
        pool.push(fail)
        assert pool.pop() == 0
        assert pool.wait_results() == [1, 4, None]
        assert len(pool.errors) == 1
    with putils.SyncProcessingPool(2) as pool:
        for i in range(6):
            pool.push(pow, i, 3)
        assert pool.wait_results() == [i**3 for i in range(6)]
