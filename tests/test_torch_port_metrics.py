"""The evaluation metrics and ``val/pesq``: diffsep_tpu_torch's numpy copies
against diffsep_tpu's on the same arrays.

``pesq_native``, ``si_bss_eval_sources`` and ``stoi`` are copies of the JAX
package's numpy modules, so they agree to 1e-6 relative (the same float64
arithmetic; measured identical). The port's ``PESQ`` takes tensors and
moves them to host numpy: the same items scored, the same mean, and a batch
where none scores raises, as in the JAX package.
"""
import logging

import numpy as np
import pytest
import torch

from diffsep_tpu.models import losses as jax_losses
from diffsep_tpu.models import metrics as jax_metrics
from diffsep_tpu.models import pesq_native as jax_pesq
from diffsep_tpu_torch.data.synthetic import tone_bursts
from diffsep_tpu_torch.models import losses, metrics, pesq_native

RTOL = 1e-6
FS = 16000


@pytest.fixture(scope="module")
def speech():
    """A clean tone-burst signal of 1.5 s and two degraded versions."""
    rng = np.random.default_rng(12)
    clean = tone_bursts(rng, int(1.5 * FS), FS, bursts=8).astype(np.float64)
    noisy = clean + 0.05 * rng.standard_normal(clean.shape)
    smeared = np.convolve(clean, np.ones(7) / 7, mode="same") + 0.01 * rng.standard_normal(clean.shape)
    return clean, noisy, smeared


@pytest.mark.parametrize("mode,fs", [("wb", 16000), ("nb", 16000), ("nb", 8000)])
def test_pesq_native_matches(speech, mode, fs):
    clean, noisy, smeared = speech
    for deg in (noisy, smeared, clean):
        ref, d = clean[::FS // fs], deg[::FS // fs]
        want = jax_pesq.pesq(fs, ref, d, mode)
        got = pesq_native.pesq(fs, ref, d, mode)
        np.testing.assert_allclose(got, want, rtol=RTOL)
    assert pesq_native.get_pesq() is pesq_native.pesq or pesq_native.get_pesq() is jax_pesq.get_pesq()


def test_pesq_native_raises_alike():
    silent = np.zeros(FS)
    for mod in (jax_pesq, pesq_native):
        with pytest.raises(ValueError):
            mod.pesq(FS, silent, silent, "wb")
    short = np.ones(FS // 10)
    with pytest.raises(pesq_native.NativePesqError):
        pesq_native.pesq(FS, short, short, "wb")


@pytest.mark.parametrize("n_src,zero_mean", [(2, False), (2, True), (3, False), (1, False)])
def test_si_bss_eval_sources_matches(rng, n_src, zero_mean):
    ref = rng.standard_normal((2, n_src, 4000))
    est = ref[:, ::-1] + 0.3 * rng.standard_normal(ref.shape)  # sources swapped: the permutation matters
    want = jax_metrics.si_bss_eval_sources(ref, est, zero_mean=zero_mean, compute_permutation=True, clamp_db=100)
    got = metrics.si_bss_eval_sources(ref, est, zero_mean=zero_mean, compute_permutation=True, clamp_db=100)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=RTOL)


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("fs", [8000, 16000])
def test_stoi_matches(speech, extended, fs):
    clean, noisy, smeared = speech
    for deg in (noisy, smeared):
        want = jax_metrics.stoi(clean, deg, fs, extended=extended)
        got = metrics.stoi(clean, deg, fs, extended=extended)
        np.testing.assert_allclose(got, want, rtol=RTOL)


def test_pesq_loss_matches_on_tensors(speech, caplog):
    clean, noisy, smeared = speech
    silent = np.zeros_like(clean)
    # (batch, [speech, noise], samples): item 2 is silent and cannot score
    ref = np.stack([np.stack([clean, noisy - clean])] * 3)
    est = np.stack([np.stack([noisy, clean - noisy]), np.stack([smeared, 0 * clean]),
                    np.stack([silent, silent])])
    ref[2, 0] = silent
    want = jax_losses.PESQ(mode="wb", fs=FS, max_items=3)(est, ref)
    with caplog.at_level(logging.WARNING, logger="diffsep_tpu_torch.models.losses"):
        got = losses.PESQ(mode="wb", fs=FS, max_items=3)(torch.from_numpy(est).float(),
                                                          torch.from_numpy(ref).float())
    np.testing.assert_allclose(got, want, rtol=1e-5)  # the tensors are float32, the JAX call float64
    assert "PESQ dropped 1/3 items" in caplog.text
    # max_items: only the first item
    np.testing.assert_allclose(losses.PESQ(max_items=1)(est, ref), jax_losses.PESQ(max_items=1)(est, ref),
                               rtol=RTOL)
    with pytest.raises(ValueError):
        losses.PESQ()(est[2:], ref[2:])  # no item scores
    with pytest.raises(ValueError, match="batch, channels, samples"):
        losses.PESQ()(est[:, 0], ref[:, 0])
