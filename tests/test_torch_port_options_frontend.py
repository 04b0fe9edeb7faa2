"""The NCSN++ pieces behind the options of the whole constructor, against
diffsep_tpu on the CPU in float32: the fused resample convs, the
activations and the positional embedding, blockwise attention, and every
frontend option of the score model (transforms, learnable constants, an
uncentered STFT), forward and gradients.

Tolerances: values within 1e-5 of their scale and gradients within 1e-5
of theirs for the resample convs (a handful of float32 products per
output; measured <= 2e-7); blockwise attention within 2e-6 of the naive
one and of JAX's, as tests/test_blockwise_attention.py holds JAX's own;
the score model within 1e-4 of its scale and parameter gradients within
1e-4 of their norm.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsep_tpu.ops.resampling as jres
from _torch_port_util import one_torch_thread, random_params  # noqa: F401  (autouse)
from diffsep_tpu.models import NCSNpp as JaxNCSNpp
from diffsep_tpu.models import ScoreModelNCSNpp as JaxScoreModel
from diffsep_tpu.models import layers as jlayers
from diffsep_tpu_torch.models import NCSNpp, ScoreModelNCSNpp, layers, state_dict_from_jax
from diffsep_tpu_torch.ops import resampling


def _vjp_pair(jfn, tfn, inputs, rng):
    """(JAX out, port out, JAX grads, port grads) of fn(*inputs), with the
    gradients of sum(out * cotangent) for one seeded cotangent."""
    want, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in inputs])
    cot = rng.standard_normal(want.shape).astype(np.float32)
    want_g = vjp(jnp.asarray(cot))
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    got = tfn(*ts)
    (got * torch.from_numpy(cot)).sum().backward()
    return np.asarray(want), got.detach().numpy(), [np.asarray(g) for g in want_g], [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("hw", [(8, 10), (7, 9), (6, 5)])
@pytest.mark.parametrize("name", ["upsample_conv_2d", "conv_downsample_2d"])
def test_fused_resample_convs_match_jax(rng, name, hw):
    """The transposed conv's asymmetric pads and the strided conv's VALID
    window, at even and odd sizes, values and both gradients."""
    x = rng.standard_normal((2, 5, *hw)).astype(np.float32)
    w = (rng.standard_normal((6, 5, 3, 3)) / 6.0).astype(np.float32)
    fir = [1.0, 3.0, 3.0, 1.0]
    want, got, want_g, got_g = _vjp_pair(lambda a, b: getattr(jres, name)(a, b, k=fir),
                                         lambda a, b: getattr(resampling, name)(a, b, k=fir), [x, w], rng)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    for g, wg in zip(got_g, want_g):
        np.testing.assert_allclose(g, wg, atol=1e-5 * np.abs(wg).max())


@pytest.mark.parametrize("name", ["naive_upsample_2d", "naive_downsample_2d"])
def test_naive_resampling_matches_jax(rng, name):
    x = rng.standard_normal((2, 3, 8, 6)).astype(np.float32)
    want = np.asarray(getattr(jres, name)(jnp.asarray(x)))
    np.testing.assert_allclose(getattr(resampling, name)(torch.from_numpy(x)).numpy(), want, atol=1e-6)


@pytest.mark.parametrize("name", ["elu", "relu", "lrelu", "swish", "silu"])
def test_activations_match_jax(rng, name):
    x = (3 * rng.standard_normal(64)).astype(np.float32)
    want = np.asarray(jlayers.get_act(name)(jnp.asarray(x)))
    np.testing.assert_allclose(layers.get_act(name)(torch.from_numpy(x)).numpy(), want, atol=1e-6)


@pytest.mark.parametrize("dim", [16, 7])
def test_timestep_embedding_matches_jax(dim):
    t = np.asarray([0.03, 0.5, 1.0, 17.0], np.float32)
    want = np.asarray(jlayers.get_timestep_embedding(jnp.asarray(t), dim))
    got = layers.get_timestep_embedding(torch.from_numpy(t), dim).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _naive(q, k, v, scale):
    w = torch.softmax((q @ k.transpose(1, 2)) * scale, dim=-1)
    return w @ v


@pytest.mark.parametrize("n,q_block,k_block", [(64, 64, 64), (137, 32, 32), (256, 64, 32), (33, 64, 64)])
def test_blockwise_attention_matches_jax_and_naive(rng, n, q_block, k_block):
    q, k, v = (rng.standard_normal((2, n, 24)).astype(np.float32) for _ in range(3))
    scale = 24 ** -0.5
    want = np.asarray(jlayers.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                                  q_block=q_block, k_block=k_block))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = layers.blockwise_attention(tq, tk, tv, scale, q_block=q_block, k_block=k_block).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=2e-6)
    np.testing.assert_allclose(got, _naive(tq, tk, tv, scale).numpy(), atol=2e-6, rtol=2e-6)


def test_attention_block_forced_either_way_matches_jax(rng, monkeypatch):
    """AttnBlockpp with DIFFSEP_ATTN_BLOCKWISE forced to 1 and to 0, on the
    same JAX params: both paths agree with each other and with JAX's."""
    x = rng.standard_normal((2, 8, 40, 16)).astype(np.float32)
    blk = jlayers.AttnBlockpp(skip_rescale=True, init_scale=0.1)
    params = blk.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    port = layers.AttnBlockpp(16, skip_rescale=True, init_scale=0.1)
    sd = state_dict_from_jax({"backbone": {"blk": params}})
    port.load_state_dict({k[len("backbone.blk."):]: v for k, v in sd.items()}, strict=True)
    out = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("DIFFSEP_ATTN_BLOCKWISE", flag)
        want = np.asarray(blk.apply({"params": params}, jnp.asarray(x)))
        with torch.no_grad():
            out[flag] = port(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(out[flag], want, atol=2e-6, rtol=2e-6)
    np.testing.assert_allclose(out["1"], out["0"], atol=2e-6, rtol=2e-6)


def test_blockwise_threshold(monkeypatch):
    monkeypatch.delenv("DIFFSEP_ATTN_BLOCKWISE", raising=False)
    assert layers.ATTN_BLOCKWISE_THRESHOLD == jlayers.ATTN_BLOCKWISE_THRESHOLD
    for n in (1, 4096, 4097, 10**6):
        assert layers.attn_blockwise(n) == jlayers._attn_blockwise(n)
    for flag in ("0", "1"):
        monkeypatch.setenv("DIFFSEP_ATTN_BLOCKWISE", flag)
        assert layers.attn_blockwise(10) == layers.attn_blockwise(10**6) == (flag == "1")


FRONTENDS = {
    # the log transform's inverse is exp(|X| / |factor|) - 1: a factor of
    # 30 keeps it finite on unit-scale random weights
    "log": dict(transform="log", spec_factor=30.0),
    "none": dict(transform="none"),
    "exponent_e1": dict(spec_abs_exponent=1.0),
    "learnable": dict(spec_trans_learnable=True),
    "learnable_log": dict(transform="log", spec_trans_learnable=True, spec_factor=30.0),
    "uncentered": dict(center=False),
}


# one level is enough backbone to carry the frontend's gradients
FRONTEND_BACKBONE = dict(nf=8, ch_mult=(1,), num_res_blocks=1, attn_resolutions=(), image_size=32,
                         num_channels_in=6, num_channels_out=4)


def _score_models(frontend):
    kw = {**dict(n_fft=62, hop_length=16, spec_factor=0.15, spec_abs_exponent=0.5), **frontend}
    jm = JaxScoreModel(backbone=JaxNCSNpp(**FRONTEND_BACKBONE), num_sources=2, **kw)
    tm = ScoreModelNCSNpp(NCSNpp(**FRONTEND_BACKBONE), num_sources=2, **kw)
    return jm, tm


def _envelope(n_samples, n_fft, hop):
    """The overlap-added squared periodic Hann window over the first
    n_samples of an uncentered iSTFT."""
    w2 = (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))) ** 2
    env = np.zeros(n_samples + n_fft)
    for start in range(0, n_samples, hop):
        env[start:start + n_fft] += w2
    return env[:n_samples].astype(np.float32)


@pytest.mark.parametrize("name", sorted(FRONTENDS))
def test_score_model_frontend_matches_jax(rng, name):
    """The score and its parameter gradients (the learnable scalars
    included) against jax.grad, on the same draws."""
    jm, tm = _score_models(FRONTENDS[name])
    params = random_params(jm, rng)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    xt = (0.3 * rng.standard_normal((2, 2, 400))).astype(np.float32)
    mix = (0.3 * rng.standard_normal((2, 1, 400))).astype(np.float32)
    t = np.asarray([0.3, 0.8], np.float32)
    cot = rng.standard_normal((2, 2, 400)).astype(np.float32)
    if not FRONTENDS[name].get("center", True):
        # uncentered, the first samples are divided by an overlap-added
        # squared window near 0, which scales both packages' rounding by up
        # to 1e3: both sides are weighted by that envelope, so that they are
        # compared as the overlap-add before its normalization
        cot = cot * _envelope(400, 62, 16)

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(xt), jnp.asarray(t), jnp.asarray(mix))
        return jnp.sum(out * cot), out

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(params)
    got = tm(torch.from_numpy(xt), torch.from_numpy(t), torch.from_numpy(mix))
    (got * torch.from_numpy(cot)).sum().backward()
    want = np.asarray(want)
    weight = 1.0 if FRONTENDS[name].get("center", True) else _envelope(400, 62, 16)
    got_w, want_w = got.detach().numpy() * weight, want * weight
    np.testing.assert_allclose(got_w, want_w, atol=1e-4 * np.abs(want_w).max())
    want_g = state_dict_from_jax(grads)
    # a parameter the transform does not read (the exponent of "log") has no
    # gradient here and a zero one in JAX
    got_g = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in tm.named_parameters() if p.requires_grad}
    assert set(got_g) <= set(want_g)
    if FRONTENDS[name].get("spec_trans_learnable"):
        assert {"spec_abs_exponent", "spec_factor"} <= set(got_g)
    norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in want_g.values()))
    for k, g in got_g.items():
        np.testing.assert_allclose(g.numpy(), want_g[k].numpy(), atol=1e-4 * norm, err_msg=k)
