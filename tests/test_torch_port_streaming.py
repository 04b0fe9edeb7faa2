"""Streaming long-form separation (diffsep_tpu_torch/streaming.py): the cases
of tests/test_streaming.py, and both packages' separate_streaming with the
same deterministic stand-in sampler give the same output (1e-6: the
stitching is the same float32 arithmetic on the host)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import one_torch_thread  # noqa: F401
from diffsep_tpu.streaming import separate_streaming as jax_separate_streaming
from diffsep_tpu_torch.streaming import _best_perm, separate_streaming


class _MockModel:
    """The get_pc_sampler contract; emits [f(y), g(y)] with a per-call
    source flip, the per-chunk permutation ambiguity of diffusion
    separation. ``nonlinear`` makes the two sources differ in more than
    sign, for the comparison with the JAX package."""

    config = {"fs": 8000}

    def __init__(self, nonlinear=False):
        self.calls = 0
        self.nonlinear = nonlinear
        self.kwargs = []

    def get_pc_sampler(self, predictor, corrector, y, generator=None, **kw):
        self.calls += 1
        self.kwargs.append(dict(kw, predictor=predictor, corrector=corrector))
        flip = self.calls % 2 == 0
        assert y.dtype == torch.float32

        def sampler():
            a = y[:, 0]
            b = torch.tanh(3 * a) + 0.1 * a if self.nonlinear else -a
            est = torch.stack([a, b], dim=1)
            return (est.flip(1) if flip else est), 6

        return sampler


class _JaxMockModel:
    class config:
        class model:
            fs = 8000

    def __init__(self):
        self.calls = 0

    def get_pc_sampler(self, predictor, corrector, y, params, key=None, **kw):
        self.calls += 1
        flip = self.calls % 2 == 0

        def sampler():
            a = y[:, 0]
            est = jnp.stack([a, jnp.tanh(3 * a) + 0.1 * a], axis=1)
            return (est[:, ::-1] if flip else est), 6

        return sampler


def test_best_perm_detects_swap():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 100))
    assert _best_perm(a, a) == (0, 1)
    assert _best_perm(a, a[::-1]) == (1, 0)
    b = rng.standard_normal((3, 100))
    assert _best_perm(b, b[[2, 0, 1]]) == (1, 2, 0)


def test_streaming_aligns_permutations_and_is_continuous():
    rng = np.random.default_rng(1)
    n = 40000  # 5 s at 8 kHz: 4 chunks of 1.5 s with 0.25 s overlap
    mix = rng.standard_normal((1, n)).astype(np.float32) * 0.1
    model = _MockModel()
    out = separate_streaming(model, mix, chunk_s=1.5, overlap_s=0.25, batch=2)
    assert out.shape == (2, n)
    assert model.calls > 1
    np.testing.assert_allclose(out[0], mix[0], atol=1e-5)
    c = np.dot(out[1], -mix[0]) / (np.linalg.norm(out[1]) * np.linalg.norm(mix[0]) + 1e-9)
    assert c > 0.99, c


def test_streaming_short_input_single_chunk():
    mix = np.random.default_rng(2).standard_normal((1, 4000)).astype(np.float32)
    model = _MockModel()
    out = separate_streaming(model, mix, chunk_s=1.0, overlap_s=0.2)
    assert out.shape == (2, 4000) and model.calls == 1
    np.testing.assert_allclose(out[0], mix[0], atol=1e-5)


def test_streaming_rejects_stereo():
    with pytest.raises(ValueError, match="mono"):
        separate_streaming(_MockModel(), np.zeros((2, 8000)))


def test_streaming_passes_the_sampler_settings():
    model = _MockModel()
    separate_streaming(model, np.ones(3000, np.float32), chunk_s=0.5, overlap_s=0.1, batch=8,
                       predictor_name="ddim", corrector_name="none", N=6)
    assert model.kwargs == [dict(N=6, predictor="ddim", corrector="none")]


@pytest.mark.parametrize("n,chunk_s,overlap_s,batch", [(40000, 1.5, 0.25, 2), (23456, 1.0, 0.5, 3),
                                                       (5000, 1.0, 0.2, 8)])
def test_streaming_matches_the_jax_package(n, chunk_s, overlap_s, batch):
    rng = np.random.default_rng(n)
    mix = (rng.standard_normal((1, n)) * 0.1 + 0.02).astype(np.float32)
    got = separate_streaming(_MockModel(nonlinear=True), mix, chunk_s=chunk_s, overlap_s=overlap_s, batch=batch)
    want = jax_separate_streaming(_JaxMockModel(), None, jax.random.PRNGKey(0), mix, chunk_s=chunk_s,
                                  overlap_s=overlap_s, batch=batch)
    assert got.shape == want.shape == (2, n)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
