"""The port's legacy blocks and normalizations (models/legacy_layers.py,
models/normalization.py) against the JAX package's, on the CPU in float32.

Each case builds the JAX module, draws its parameters (and batch-norm
statistics) from a seeded numpy generator, carries them across with
``legacy_state_dict_from_jax`` (loaded with ``strict=True``) and feeds both
modules the same seeded input. Tolerance: 2e-5 of max(1, max|JAX output|),
the bound of the JAX package's own parity test against the reference
(tests/test_legacy_reference_parity.py). Port modules run in eval mode
except where a case says train.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffsep_tpu.models import legacy_layers as JL
from diffsep_tpu.models import normalization as JN
from diffsep_tpu_torch.models import legacy_layers as PL
from diffsep_tpu_torch.models import normalization as PN
from diffsep_tpu_torch.models.convert import legacy_state_dict_from_jax
from diffsep_tpu_torch.ops import conv3x3 as conv_ops

TOL = 2e-5
LABELS = np.array([0, 3])


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


X = _x((2, 8, 8, 6), 10)
X_SMALL = _x((2, 4, 4, 3), 11)
X_WIDE = _x((2, 8, 8, 32), 12)
TEMB = _x((2, 16), 13)


def _jax_norm(cls, **kw):
    return lambda f, name=None: cls(f, name=name, **kw)


# name -> (JAX module, port module, inputs); the inputs: arrays (int arrays
# are class labels), lists of arrays, and static shapes (tuples)
CASES = {
    # normalizations
    "InstanceNorm2dPlus": (lambda: JN.InstanceNorm2dPlus(6), lambda: PN.InstanceNorm2dPlus(6), (X,)),
    "InstanceNorm2dPlus_nobias": (lambda: JN.InstanceNorm2dPlus(6, bias=False),
                                  lambda: PN.InstanceNorm2dPlus(6, bias=False), (X,)),
    "ConditionalInstanceNorm2dPlus": (lambda: JN.ConditionalInstanceNorm2dPlus(6, 4),
                                      lambda: PN.ConditionalInstanceNorm2dPlus(6, 4), (X, LABELS)),
    "ConditionalInstanceNorm2dPlus_nobias": (lambda: JN.ConditionalInstanceNorm2dPlus(6, 4, bias=False),
                                             lambda: PN.ConditionalInstanceNorm2dPlus(6, 4, bias=False), (X, LABELS)),
    "VarianceNorm2d": (lambda: JN.VarianceNorm2d(6), lambda: PN.VarianceNorm2d(6), (X,)),
    "ConditionalVarianceNorm2d": (lambda: JN.ConditionalVarianceNorm2d(6, 4),
                                  lambda: PN.ConditionalVarianceNorm2d(6, 4), (X, LABELS)),
    "ConditionalInstanceNorm2d": (lambda: JN.ConditionalInstanceNorm2d(6, 4),
                                  lambda: PN.ConditionalInstanceNorm2d(6, 4), (X, LABELS)),
    "ConditionalInstanceNorm2d_nobias": (lambda: JN.ConditionalInstanceNorm2d(6, 4, bias=False),
                                         lambda: PN.ConditionalInstanceNorm2d(6, 4, bias=False), (X, LABELS)),
    "ConditionalNoneNorm2d": (lambda: JN.ConditionalNoneNorm2d(6, 4),
                              lambda: PN.ConditionalNoneNorm2d(6, 4), (X, LABELS)),
    "ConditionalNoneNorm2d_nobias": (lambda: JN.ConditionalNoneNorm2d(6, 4, bias=False),
                                     lambda: PN.ConditionalNoneNorm2d(6, 4, bias=False), (X, LABELS)),
    "ConditionalBatchNorm2d_eval": (lambda: JN.ConditionalBatchNorm2d(6, 4),
                                    lambda: PN.ConditionalBatchNorm2d(6, 4), (X, LABELS)),
    "ConditionalBatchNorm2d_nobias_eval": (lambda: JN.ConditionalBatchNorm2d(6, 4, bias=False),
                                           lambda: PN.ConditionalBatchNorm2d(6, 4, bias=False), (X, LABELS)),
    "InstanceNorm2d": (lambda: JN.InstanceNorm2d(6), lambda: PN.InstanceNorm2d(6), (X,)),
    "NoneNorm2d": (lambda: JN.NoneNorm2d(6), lambda: PN.NoneNorm2d(6), (X,)),
    # RefineNet blocks
    "CRPBlock_maxpool": (lambda: JL.CRPBlock(6, 3), lambda: PL.CRPBlock(6, 3), (X,)),
    "CRPBlock_avgpool": (lambda: JL.CRPBlock(6, 2, maxpool=False), lambda: PL.CRPBlock(6, 2, maxpool=False), (X,)),
    "CondCRPBlock": (lambda: JL.CondCRPBlock(6, 2, 4, JN.ConditionalInstanceNorm2dPlus),
                     lambda: PL.CondCRPBlock(6, 2, 4, PN.ConditionalInstanceNorm2dPlus), (X, LABELS)),
    "RCUBlock": (lambda: JL.RCUBlock(6, 2, 2), lambda: PL.RCUBlock(6, 2, 2), (X,)),
    "CondRCUBlock": (lambda: JL.CondRCUBlock(6, 2, 2, 4, JN.ConditionalInstanceNorm2dPlus),
                     lambda: PL.CondRCUBlock(6, 2, 2, 4, PN.ConditionalInstanceNorm2dPlus), (X, LABELS)),
    "MSFBlock": (lambda: JL.MSFBlock(5), lambda: PL.MSFBlock([6, 3], 5), ([X, X_SMALL], (8, 8))),
    "MSFBlock_upsize": (lambda: JL.MSFBlock(5), lambda: PL.MSFBlock([6, 3], 5), ([X, X_SMALL], (13, 11))),
    "CondMSFBlock": (lambda: JL.CondMSFBlock(5, 4, JN.ConditionalInstanceNorm2dPlus),
                     lambda: PL.CondMSFBlock([6, 3], 5, 4, PN.ConditionalInstanceNorm2dPlus),
                     ([X, X_SMALL], LABELS, (8, 8))),
    "RefineBlock_single_end": (lambda: JL.RefineBlock(6, end=True), lambda: PL.RefineBlock([6], 6, end=True),
                               ([X], (16, 16))),
    "RefineBlock_fusion": (lambda: JL.RefineBlock(6), lambda: PL.RefineBlock([6, 3], 6), ([X, X_SMALL], (8, 8))),
    "RefineBlock_avgpool": (lambda: JL.RefineBlock(6, maxpool=False),
                            lambda: PL.RefineBlock([6, 3], 6, maxpool=False), ([X, X_SMALL], (8, 8))),
    "CondRefineBlock_single": (lambda: JL.CondRefineBlock(6, 4, JN.ConditionalInstanceNorm2dPlus, end=True),
                               lambda: PL.CondRefineBlock([6], 6, 4, PN.ConditionalInstanceNorm2dPlus, end=True),
                               ([X], LABELS, (8, 8))),
    "CondRefineBlock_fusion_batchnorm": (lambda: JL.CondRefineBlock(6, 4, JN.ConditionalBatchNorm2d),
                                         lambda: PL.CondRefineBlock([6, 3], 6, 4, PN.ConditionalBatchNorm2d),
                                         ([X, X_SMALL], LABELS, (8, 8))),
    # resampling convs
    "ConvMeanPool": (lambda: JL.ConvMeanPool(5), lambda: PL.ConvMeanPool(6, 5), (X,)),
    "ConvMeanPool_adjust_padding": (lambda: JL.ConvMeanPool(5, adjust_padding=True),
                                    lambda: PL.ConvMeanPool(6, 5, adjust_padding=True), (_x((2, 7, 9, 6), 14),)),
    "ConvMeanPool_1x1_nobias": (lambda: JL.ConvMeanPool(5, 1, biases=False),
                                lambda: PL.ConvMeanPool(6, 5, 1, biases=False), (X,)),
    "MeanPoolConv": (lambda: JL.MeanPoolConv(5), lambda: PL.MeanPoolConv(6, 5), (X,)),
    "UpsampleConv_C1": (lambda: JL.UpsampleConv(4), lambda: PL.UpsampleConv(1, 4), (_x((2, 5, 6, 1), 15),)),
    "UpsampleConv_C3": (lambda: JL.UpsampleConv(4), lambda: PL.UpsampleConv(3, 4), (X_SMALL,)),
    "UpsampleConv_C6": (lambda: JL.UpsampleConv(5), lambda: PL.UpsampleConv(6, 5), (X,)),
    # residual blocks
    "ResidualBlock_same": (lambda: JL.ResidualBlock(6), lambda: PL.ResidualBlock(6, 6), (X,)),
    "ResidualBlock_widen": (lambda: JL.ResidualBlock(12), lambda: PL.ResidualBlock(6, 12), (X,)),
    "ResidualBlock_down": (lambda: JL.ResidualBlock(12, resample="down"),
                           lambda: PL.ResidualBlock(6, 12, resample="down"), (X,)),
    "ResidualBlock_down_adjust_padding": (lambda: JL.ResidualBlock(12, resample="down", adjust_padding=True),
                                          lambda: PL.ResidualBlock(6, 12, resample="down", adjust_padding=True),
                                          (_x((2, 7, 7, 6), 16),)),
    "ResidualBlock_dilated_same": (lambda: JL.ResidualBlock(6, dilation=2),
                                   lambda: PL.ResidualBlock(6, 6, dilation=2), (X,)),
    "ResidualBlock_dilated_widen": (lambda: JL.ResidualBlock(12, dilation=2),
                                    lambda: PL.ResidualBlock(6, 12, dilation=2), (X,)),
    "ResidualBlock_dilated_down": (lambda: JL.ResidualBlock(12, resample="down", dilation=2),
                                   lambda: PL.ResidualBlock(6, 12, resample="down", dilation=2), (X,)),
    "ResidualBlock_instancenorm_plus": (
        lambda: JL.ResidualBlock(12, normalization=_jax_norm(JN.InstanceNorm2dPlus)),
        lambda: PL.ResidualBlock(6, 12, normalization=PN.InstanceNorm2dPlus), (X,)),
    "ResidualBlock_variancenorm_down": (
        lambda: JL.ResidualBlock(12, resample="down", normalization=_jax_norm(JN.VarianceNorm2d)),
        lambda: PL.ResidualBlock(6, 12, resample="down", normalization=PN.VarianceNorm2d), (X,)),
    "ResidualBlock_nonenorm_elu": (lambda: JL.ResidualBlock(6, normalization=_jax_norm(JN.NoneNorm2d)),
                                   lambda: PL.ResidualBlock(6, 6, normalization=PN.NoneNorm2d), (X,)),
    "ConditionalResidualBlock_same": (lambda: JL.ConditionalResidualBlock(6, 4),
                                      lambda: PL.ConditionalResidualBlock(6, 6, 4), (X, LABELS)),
    "ConditionalResidualBlock_widen": (lambda: JL.ConditionalResidualBlock(12, 4),
                                       lambda: PL.ConditionalResidualBlock(6, 12, 4), (X, LABELS)),
    "ConditionalResidualBlock_down": (lambda: JL.ConditionalResidualBlock(12, 4, resample="down"),
                                      lambda: PL.ConditionalResidualBlock(6, 12, 4, resample="down"), (X, LABELS)),
    "ConditionalResidualBlock_dilated_widen": (lambda: JL.ConditionalResidualBlock(12, 4, dilation=2),
                                               lambda: PL.ConditionalResidualBlock(6, 12, 4, dilation=2),
                                               (X, LABELS)),
    "ConditionalResidualBlock_dilated_down": (
        lambda: JL.ConditionalResidualBlock(12, 4, resample="down", dilation=2),
        lambda: PL.ConditionalResidualBlock(6, 12, 4, resample="down", dilation=2), (X, LABELS)),
    "ConditionalResidualBlock_batchnorm": (
        lambda: JL.ConditionalResidualBlock(12, 4, normalization=JN.ConditionalBatchNorm2d),
        lambda: PL.ConditionalResidualBlock(6, 12, 4, normalization=PN.ConditionalBatchNorm2d), (X, LABELS)),
    "ConditionalResidualBlock_variancenorm": (
        lambda: JL.ConditionalResidualBlock(6, 4, normalization=JN.ConditionalVarianceNorm2d),
        lambda: PL.ConditionalResidualBlock(6, 6, 4, normalization=PN.ConditionalVarianceNorm2d), (X, LABELS)),
    # DDPM
    "ResnetBlockDDPM_temb": (lambda: JL.ResnetBlockDDPM(act=jax.nn.silu),
                             lambda: PL.ResnetBlockDDPM(F.silu, 32, temb_dim=16), (X_WIDE, TEMB)),
    "ResnetBlockDDPM_nin": (lambda: JL.ResnetBlockDDPM(act=jax.nn.silu, out_ch=64),
                            lambda: PL.ResnetBlockDDPM(F.silu, 32, 64, temb_dim=16), (X_WIDE, TEMB)),
    "ResnetBlockDDPM_conv_shortcut": (lambda: JL.ResnetBlockDDPM(act=jax.nn.silu, out_ch=64, conv_shortcut=True),
                                      lambda: PL.ResnetBlockDDPM(F.silu, 32, 64, conv_shortcut=True),
                                      (X_WIDE,)),
}


def _to_jax(a):
    if isinstance(a, list):
        return [_to_jax(v) for v in a]
    if isinstance(a, np.ndarray):
        return jnp.asarray(a)
    return a


def _to_torch(a):
    if isinstance(a, list):
        return [_to_torch(v) for v in a]
    if isinstance(a, np.ndarray):
        return torch.from_numpy(a).long() if a.dtype.kind == "i" else torch.from_numpy(a)
    return a


def _randomized(variables, seed):
    """Every parameter perturbed by 0.1 N(0, 1), so init_scale=0 layers
    and the embeddings' constant columns count; batch statistics drawn."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.float32(0.1) * rng.standard_normal(a.shape).astype(np.float32),
        variables.get("params", {}))
    stats = None
    if "batch_stats" in variables:
        stats = jax.tree_util.tree_map_with_path(
            lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if p[-1].key == "var"
                          else 0.3 * rng.standard_normal(a.shape)).astype(np.float32),
            variables["batch_stats"])
    return params, stats


def build_pair(name, seed=0):
    """(JAX module, its params, its batch stats, port module loaded
    strictly with them, JAX inputs, port inputs)."""
    make_jax, make_port, inputs = CASES[name]
    jmod, pmod = make_jax(), make_port()
    jargs = [_to_jax(a) for a in inputs]
    params, stats = _randomized(jmod.init(jax.random.PRNGKey(seed), *jargs), seed)
    pmod.load_state_dict(legacy_state_dict_from_jax(params, stats), strict=True)
    return jmod, params, stats, pmod.eval(), jargs, [_to_torch(a) for a in inputs]


def _variables(params, stats):
    return {"params": params, **({"batch_stats": stats} if stats is not None else {})}


def _assert_close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.detach().numpy() - want).max())
    assert got.shape == want.shape
    assert err <= TOL * scale, (err, scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_matches_jax(name):
    jmod, params, stats, pmod, jargs, pargs = build_pair(name)
    want = jmod.apply(_variables(params, stats), *jargs)
    with torch.no_grad():
        got = pmod(*pargs)
    _assert_close(got, want)


@pytest.mark.parametrize("bias", [True, False])
def test_conditional_batch_norm_train_updates_running_stats_as_jax(bias):
    """Train mode: the biased batch variance normalizes, the unbiased one
    goes into running_var with momentum 0.1; then eval reads them."""
    name = "ConditionalBatchNorm2d_eval" if bias else "ConditionalBatchNorm2d_nobias_eval"
    jmod, params, stats, pmod, jargs, pargs = build_pair(name, seed=3)
    want, mutated = jmod.apply(_variables(params, stats), *jargs, train=True, mutable=["batch_stats"])
    pmod.train()
    with torch.no_grad():
        got = pmod(*pargs)
    _assert_close(got, want)
    _assert_close(pmod.bn.running_mean, mutated["batch_stats"]["bn"]["mean"])
    _assert_close(pmod.bn.running_var, mutated["batch_stats"]["bn"]["var"])
    pmod.eval()
    want = jmod.apply({"params": params, "batch_stats": mutated["batch_stats"]}, *jargs)
    with torch.no_grad():
        _assert_close(pmod(*pargs), want)


@pytest.mark.parametrize("norm", ["InstanceNorm", "InstanceNorm++", "VarianceNorm", "GroupNorm"])
def test_get_normalization_matches_jax(norm):
    class Cfg:
        class model:
            normalization = norm
            num_classes = 4

    jmod = JN.get_normalization(Cfg)(8)
    pmod = PN.get_normalization({"model": {"normalization": norm}})(8)
    x = _x((2, 5, 6, 8), 17)
    params, _ = _randomized(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    pmod.load_state_dict(legacy_state_dict_from_jax(params), strict=True)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        _assert_close(pmod(torch.from_numpy(x)), want)


def test_get_normalization_conditional():
    class Cfg:
        class model:
            normalization = "InstanceNorm++"
            num_classes = 4

    factory = PN.get_normalization(Cfg, conditional=True)
    assert isinstance(factory(6), PN.ConditionalInstanceNorm2dPlus)
    assert factory(6).embed.num_embeddings == 4
    with pytest.raises(NotImplementedError):
        PN.get_normalization({"model": {"normalization": "VarianceNorm"}}, conditional=True)
    with pytest.raises(ValueError):
        PN.get_normalization({"model": {"normalization": "BatchNorm"}})


# 3x3 stride-1 undilated convs of each block: the calls that take the hand
# kernel's op (ops/conv3x3.conv3x3) on the card
KERNEL_CONVS = {
    "CRPBlock_maxpool": 3, "CondCRPBlock": 2, "RCUBlock": 4, "MSFBlock": 2, "RefineBlock_fusion": 14,
    "CondRefineBlock_single": 12, "ConvMeanPool": 1, "ConvMeanPool_1x1_nobias": 0, "MeanPoolConv": 1,
    "UpsampleConv_C6": 1, "ResidualBlock_down": 2, "ResidualBlock_dilated_same": 0,
    "ResidualBlock_dilated_down": 0, "ConditionalResidualBlock_dilated_widen": 0,
    "ResnetBlockDDPM_nin": 2, "ResnetBlockDDPM_conv_shortcut": 3,
}


@pytest.mark.parametrize("name", sorted(KERNEL_CONVS))
def test_undilated_3x3_convs_take_the_kernel_op(name, monkeypatch):
    calls = []
    real = conv_ops.conv3x3

    def counting(x, w, b=None):
        calls.append(tuple(x.shape))
        return real(x, w, b)

    monkeypatch.setattr(conv_ops, "conv3x3", counting)
    *_, pmod, _, pargs = build_pair(name)
    with torch.no_grad():
        pmod(*pargs)
    assert len(calls) == KERNEL_CONVS[name]


def test_ddpm_dropout_is_train_mode_only():
    *_, pmod, _, pargs = build_pair("ResnetBlockDDPM_temb")
    with torch.no_grad():
        a, b = pmod(*pargs), pmod(*pargs)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        pmod.train()
        torch.manual_seed(0)
        assert not torch.equal(pmod(*pargs), a)


@pytest.mark.parametrize("name", ["CondRefineBlock_fusion_batchnorm", "ConditionalResidualBlock_variancenorm",
                                  "ResidualBlock_instancenorm_plus", "ResnetBlockDDPM_nin", "ConditionalNoneNorm2d"])
def test_reset_parameters_draws_from_the_generator(name):
    """Every learned parameter is drawn from the generator it is given,
    whatever the global generator's state."""
    make = CASES[name][1]
    a, b = make(), make()
    PL.reset_parameters(a, torch.Generator().manual_seed(5))
    torch.manual_seed(123)
    PL.reset_parameters(b, torch.Generator().manual_seed(5))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    PL.reset_parameters(b, torch.Generator().manual_seed(6))
    assert any(not torch.equal(sa[k], v) for k, v in b.state_dict().items() if v.is_floating_point() and v.ndim)


def test_residual_block_rejects_unknown_resample():
    with pytest.raises(ValueError):
        PL.ResidualBlock(6, 6, resample="up")
    with pytest.raises(ValueError):
        PL.ConditionalResidualBlock(6, 6, 4, resample="up")


def test_legacy_state_dict_keys():
    """Module lists, embeddings and InstanceNorm++'s factors under the
    reference's names."""
    _, params, _, pmod, _, _ = build_pair("CondRefineBlock_single")
    sd = legacy_state_dict_from_jax(params)
    assert "adapt_convs.0.1_1_conv.weight" in sd and "crp.norms.1.embed.weight" in sd
    _, params, _, pmod, _, _ = build_pair("InstanceNorm2dPlus")
    sd = legacy_state_dict_from_jax(params)
    np.testing.assert_array_equal(sd["alpha"].numpy(), np.asarray(params["alpha"]) + np.float32(1))
