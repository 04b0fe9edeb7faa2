"""diffsep_tpu_torch ScoreModelNCSNpp vs diffsep_tpu (CPU, float32).

A tiny NCSN++ (nf=8, ch_mult (1, 2, 2), attention at 16) with seeded random
weights carried across by state_dict_from_jax. The score is a stack of ~40
layers of float32 convolutions, matrix products and GroupNorms evaluated in
another order by XLA and by PyTorch; the tolerance is 1e-4 of the output's
largest magnitude (measured agreement ~1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import (
    jax_score_model, load_port_weights, port_score_model, random_params,
)
from diffsep_tpu.models.convert import flax_to_score_model_state_dict
from diffsep_tpu_torch.models import layers, state_dict_from_jax

REL = 1e-4


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(1)
    jm = jax_score_model()
    params = random_params(jm, rng)
    tm = port_score_model()
    load_port_weights(tm, params)
    return jm, params, tm


def test_state_dict_matches_reference_layout(models):
    _, params, tm = models
    sd = state_dict_from_jax(params)
    ref = flax_to_score_model_state_dict(params)
    assert set(sd) == set(ref) == set(tm.state_dict())
    for k, v in ref.items():
        assert tuple(sd[k].shape) == v.shape, k
        np.testing.assert_array_equal(sd[k].numpy(), v)
    assert any(".NIN_3.W" in k for k in sd)  # attention is in the walk


def test_attention_fires_at_16(models):
    _, _, tm = models
    n_attn = sum(isinstance(m, layers.AttnBlockpp) for m in tm.backbone.all_modules)
    assert n_attn == 3  # down path, bottleneck, up path


@pytest.mark.parametrize("t", [[0.7, 0.05], [1.0, 0.03]])
def test_score_forward_matches(models, rng, t):
    jm, params, tm = models
    xt = rng.standard_normal((2, 2, 1000)).astype(np.float32)
    mix = rng.standard_normal((2, 1, 1000)).astype(np.float32)
    t = np.asarray(t, np.float32)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, xt, t, mix))
    with torch.no_grad():
        got = tm(torch.from_numpy(xt), torch.from_numpy(t), torch.from_numpy(mix)).numpy()
    assert got.shape == want.shape == (2, 2, 1000)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=REL * scale)


def test_backbone_bf16_runs_and_stays_close(models, rng):
    """The bf16 compute path (conv/attention in bf16, f32 statistics) runs
    on the CPU plain versions and stays near the f32 result: bf16 keeps 8
    bits of mantissa, so agreement is held to 5% of the output scale."""
    _, _, tm = models
    x = torch.from_numpy(rng.standard_normal((1, 64, 64, 6)).astype(np.float32))
    t = torch.tensor([0.5])
    with torch.no_grad():
        ref = tm.backbone(x, t)
        tm.backbone.compute_dtype = torch.bfloat16
        try:
            got = tm.backbone(x, t)
        finally:
            tm.backbone.compute_dtype = torch.float32
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 0.05 * ref.abs().max()
