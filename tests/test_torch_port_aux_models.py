"""The library backbones of diffsep_tpu_torch, TemporalConvNet (Conv-TasNet
TCN) and DPTNet, against diffsep_tpu's, on the CPU in float32, at the sizes
of tests/test_aux_models.py.

Each JAX module's parameters are filled with seeded numpy values of unit
scale (PReLU slopes and norm scales included) and carried across with
``tcn_state_dict_from_jax`` / ``dptnet_state_dict_from_jax``
(``strict=True``). Outputs are held within 1e-5 of their scale, parameter
gradients within 1e-4 of the gradient norm (max |difference| over the
global L2 norm).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from diffsep_tpu.models.dptnet import DPTNet as JaxDPTNet
from diffsep_tpu.models.tcn import TemporalConvNet as JaxTCN
from diffsep_tpu_torch.models import DPTNet, TemporalConvNet, dptnet_state_dict_from_jax, tcn_state_dict_from_jax
from diffsep_tpu_torch.models.model_utils import get_activation

TCN_SIZE = dict(N=16, B=8, H=12, P=3, X=2, R=2, C=2)
DPT_SIZE = dict(input_size=8, hidden_size=12, output_size=6, att_heads=2)


def _params(module, x, seed):
    """The module's parameter tree filled with seeded values: fan-in scaled
    weights, 0.25 +- 0.1 PReLU slopes, 1 +- 0.1 norm scales, 0.1-scale
    biases."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)["params"]

    def leaf(path, s):
        name = path[-1].key
        if name == "alpha":
            return np.float32(0.25 + 0.1 * rng.standard_normal())
        if name in ("gamma", "scale"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if len(s.shape) >= 2 and name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _close(got, want, rel=1e-5):
    assert got.shape == want.shape
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _flax_part(name: str, arr: np.ndarray, rnn: str) -> np.ndarray:
    """The entries of a port parameter that some flax parameter maps to.
    torch's packed RNNs carry a bias flax's cells lack (the LSTM's input
    bias, the GRU's r and z hidden biases, the simple cell's hidden bias):
    the converter sets it to 0, where the forward equals flax's, but its
    gradient is that of its twin bias, not flax's 0."""
    if ".rnn.bias_ih" in name and rnn == "LSTM" or ".rnn.bias_hh" in name and rnn == "RNN":
        return arr[:0]
    if ".rnn.bias_hh" in name and rnn == "GRU":
        return arr[2 * arr.shape[0] // 3:]
    return arr


def _grads_close(jmodule, params, x, tmodule, convert, seed, rnn=None):
    w = np.random.default_rng(seed).standard_normal(jmodule.apply({"params": params}, x).shape).astype(np.float32)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(jmodule.apply({"params": p}, x) * w)))(params)
    want = {k: _flax_part(k, v.numpy(), rnn) for k, v in convert(grads).items()}
    tmodule.zero_grad()
    (tmodule(torch.from_numpy(np.asarray(x))) * torch.from_numpy(w)).sum().backward()
    got = {k: _flax_part(k, p.grad.numpy(), rnn) for k, p in tmodule.named_parameters()}
    assert got.keys() == want.keys()
    want = {k: v for k, v in want.items() if v.size}
    norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in want.values()))
    assert max(np.abs(got[k] - want[k]).max() for k in want) <= 1e-4 * norm


TCN_CASES = [(norm, causal, "relu") for norm in ("gLN", "cLN", "BN", "GN") for causal in (False, True)] + [
    ("gLN", False, m) for m in ("softmax", "sigmoid", "tanh")] + [("cLN", True, "softmax")]


@pytest.mark.parametrize("norm,causal,mask", TCN_CASES, ids=["-".join(map(str, c)) for c in TCN_CASES])
def test_tcn_matches_jax(norm, causal, mask):
    kw = dict(TCN_SIZE, norm_type=norm, causal=causal, mask_nonlinear=mask)
    x = np.random.default_rng(1).standard_normal((2, 16, 40)).astype(np.float32)
    jm = JaxTCN(**kw)
    params = _params(jm, x, 2)
    want = np.asarray(jm.apply({"params": params}, x))
    tm = TemporalConvNet(**kw)
    tm.load_state_dict(tcn_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2, 16, 40)
    _close(got, want)


def test_tcn_causal_output_ignores_the_future():
    """A causal TCN's mask at frame k does not depend on frames after k
    (cLN, which normalizes each frame on its own)."""
    tm = TemporalConvNet(N=8, B=4, H=6, P=3, X=2, R=1, C=2, norm_type="cLN", causal=True)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 8, 32)).astype(np.float32))
    x2 = x.clone()
    x2[..., 20:] += 1.0
    with torch.no_grad():
        torch.testing.assert_close(tm(x)[..., :20], tm(x2)[..., :20], rtol=0, atol=0)


def test_tcn_gradients_match_jax():
    kw = dict(TCN_SIZE, norm_type="gLN", causal=True)
    x = np.random.default_rng(4).standard_normal((2, 16, 40)).astype(np.float32)
    jm = JaxTCN(**kw)
    params = _params(jm, x, 5)
    tm = TemporalConvNet(**kw)
    tm.load_state_dict(tcn_state_dict_from_jax(params), strict=True)
    _grads_close(jm, params, x, tm, tcn_state_dict_from_jax, 6)


DPT_CASES = [(rnn, bi, "gLN", 1) for rnn in ("LSTM", "GRU", "RNN") for bi in (True, False)] + [
    ("LSTM", True, "cLN", 1), ("GRU", False, "GN", 2)]


@pytest.mark.parametrize("rnn,bi,norm,layers", DPT_CASES, ids=["-".join(map(str, c)) for c in DPT_CASES])
def test_dptnet_matches_jax(rnn, bi, norm, layers):
    kw = dict(DPT_SIZE, rnn_type=rnn, bidirectional=bi, norm_type=norm, num_layers=layers)
    x = np.random.default_rng(7).standard_normal((1, 8, 10, 4)).astype(np.float32)
    jm = JaxDPTNet(**kw)
    params = _params(jm, x, 8)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    tm = DPTNet(**kw).eval()
    tm.load_state_dict(dptnet_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 6, 10, 4)
    _close(got, want)


@pytest.mark.parametrize("rnn", ["LSTM", "GRU", "RNN"])
def test_dptnet_gradients_match_jax(rnn):
    kw = dict(DPT_SIZE, rnn_type=rnn, bidirectional=True)
    x = np.random.default_rng(9).standard_normal((2, 8, 10, 4)).astype(np.float32)
    jm = JaxDPTNet(**kw)
    params = _params(jm, x, 10)
    tm = DPTNet(**kw).eval()
    tm.load_state_dict(dptnet_state_dict_from_jax(params), strict=True)
    _grads_close(jm, params, x, tm, dptnet_state_dict_from_jax, 11, rnn)


def test_unsupported_settings_raise():
    with pytest.raises(ValueError, match="normalization"):
        TemporalConvNet(**TCN_SIZE, norm_type="LN")
    with pytest.raises(ValueError, match="mask"):
        TemporalConvNet(**TCN_SIZE, mask_nonlinear="gelu")
    with pytest.raises(ValueError, match="LSTM"):
        DPTNet(rnn_type="SRU", **DPT_SIZE)
    with pytest.raises(ValueError, match="activation"):
        get_activation("gelu")
    x = torch.linspace(-3, 3, 13)
    torch.testing.assert_close(get_activation("hardtanh")(x), torch.clamp(x, -1, 1))
    torch.testing.assert_close(get_activation("swish")(x), x * torch.sigmoid(x))
