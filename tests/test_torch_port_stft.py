"""diffsep_tpu_torch STFT and score-model frontend vs diffsep_tpu (CPU, f32).

Both sides compute the DFT as a float32 matrix product against the same
basis; sums of n_fft terms in another order differ by ~1e-6 relative, so
spectra are compared at atol 1e-4 on unit-scale signals and signals at
atol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsep_tpu.models import ScoreModelNCSNpp as JaxScoreModel
from diffsep_tpu.ops.stft import hann_window as jax_hann_window
from diffsep_tpu.ops.stft import istft as jax_istft
from diffsep_tpu.ops.stft import stft as jax_stft
from diffsep_tpu_torch.models import ScoreModelNCSNpp
import diffsep_tpu_torch.ops.stft as tstft

CONFIGS = [(510, 128), (126, 32)]


@pytest.mark.parametrize("n_fft,hop", CONFIGS)
def test_stft_istft_match(rng, n_fft, hop):
    x = rng.standard_normal((2, 3, 4000)).astype(np.float32)
    win = jnp.asarray(jax_hann_window(n_fft))
    want = np.asarray(jax_stft(jnp.asarray(x), n_fft, hop, win))
    got = tstft.stft(torch.from_numpy(x), n_fft, hop, torch.from_numpy(tstft.hann_window(n_fft)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    back_j = np.asarray(jax_istft(jnp.asarray(want), n_fft, hop, win, length=4000))
    back_t = tstft.istft(got, n_fft, hop, length=4000).numpy()
    np.testing.assert_allclose(back_t, back_j, atol=1e-5)
    # exact reconstruction where whole frames cover the signal
    covered = (4000 // hop) * hop - n_fft // 2
    np.testing.assert_allclose(back_t[..., :covered], x[..., :covered], atol=1e-5)


def test_stft_matches_torch_stft(rng):
    """torch.stft with constant padding is the semantics both packages copy."""
    x = rng.standard_normal((2, 4000)).astype(np.float32)
    win = torch.hann_window(510)
    want = torch.stft(torch.from_numpy(x), 510, 128, window=win, center=True,
                      pad_mode="constant", return_complex=True)
    got = tstft.stft(torch.from_numpy(x), 510, 128)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


@pytest.mark.parametrize("n_fft,hop", CONFIGS)
def test_pre_post_process_match(rng, n_fft, hop):
    kw = dict(num_sources=2, n_fft=n_fft, hop_length=hop, spec_factor=0.15,
              spec_abs_exponent=0.5)
    jm = JaxScoreModel(backbone=None, **kw)
    tm = ScoreModelNCSNpp(torch.nn.Identity(), **kw)
    x = rng.standard_normal((2, 3, 5000)).astype(np.float32)
    jh, jn, jpad = jm.pre_process(jnp.asarray(x))
    th, tn, tpad = tm.pre_process(torch.from_numpy(x))
    assert (tn, tpad) == (jn, jpad) and th.shape == jh.shape
    assert th.shape[2] % 64 == 0
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
    # the inverse chain on the same spectrogram-domain input
    y = rng.standard_normal(th.shape[:3] + (4,)).astype(np.float32) * 0.1
    want = np.asarray(jm.post_process(jnp.asarray(y), jn, jpad))
    got = tm.post_process(torch.from_numpy(y), tn, tpad).numpy()
    assert got.shape == want.shape == (2, 2, 5000)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # pre -> post is the identity on the signal
    back = tm.post_process(th, tn, tpad).numpy()
    np.testing.assert_allclose(back, x, atol=1e-4)
