"""Evaluation metrics: SI-SDR/SI-SIR/SI-SAR with PIT, and STOI/ESTOI.

The port's own copy of ``diffsep_tpu/models/metrics.py`` (numpy only):

  * `si_bss_eval_sources` - scale-invariant BSS eval (Le Roux et al. 2019):
    s_target = orthogonal projection on the matched reference,
    e_interf  = projection on the reference subspace minus s_target,
    e_artif   = residual outside the reference subspace,
    SDR = ||s_t||^2/||e_i + e_a||^2, SIR = ||s_t||^2/||e_i||^2,
    SAR = ||s_t + e_i||^2/||e_a||^2, permutation maximizing mean SI-SDR.

  * `stoi` - Short-Time Objective Intelligibility (Taal et al. 2011) and
    its extended variant (Jensen & Taal 2016).

PESQ is ``models/pesq_native.py`` (``models/losses.py`` PESQ).
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np

__all__ = ["si_bss_eval_sources", "stoi"]

_EPS = 1e-10


def _project_decompose(ref: np.ndarray, est: np.ndarray):
    """Per (ref i, est j) pair energy terms of the SI-BSS decomposition.

    ref, est: (n_src, T), zero-mean optional upstream.
    Returns (sdr, sir, sar) matrices shaped (n_ref, n_est).
    """
    n_src, T = ref.shape
    # Gram matrix of references and cross-correlations
    G = ref @ ref.T  # (n, n)
    C = ref @ est.T  # (n_ref, n_est)

    # full-subspace projection coefficients: a = G^{-1} C  (n_ref, n_est)
    A = np.linalg.solve(G + _EPS * np.eye(n_src), C)
    # ||P_s est_j||^2 = a_j^T G a_j
    proj_pow = np.einsum("ij,ik,kj->j", A, G, A)  # (n_est,)
    est_pow = np.sum(est**2, axis=-1)  # (n_est,)
    e_artif_pow = np.maximum(est_pow - proj_pow, _EPS)  # (n_est,)

    ref_pow = np.diag(G)  # (n_ref,)
    starget_pow = C**2 / np.maximum(ref_pow[:, None], _EPS)  # (i, j)
    e_interf_pow = np.maximum(proj_pow[None, :] - starget_pow, _EPS)

    sdr = starget_pow / np.maximum(
        est_pow[None, :] - starget_pow, _EPS
    )  # ||est - s_t||^2 = e_i + e_a
    sir = starget_pow / e_interf_pow
    # SAR depends only on the estimate; broadcast over the ref axis
    sar = np.broadcast_to(
        proj_pow[None, :] / e_artif_pow[None, :], sdr.shape
    ).copy()
    return sdr, sir, sar


def _db(x, clamp_db: Optional[float]):
    v = 10.0 * np.log10(np.maximum(x, 1e-30))
    if clamp_db is not None:
        v = np.clip(v, -clamp_db, clamp_db)
    return v


def si_bss_eval_sources(
    ref,
    est,
    zero_mean: bool = False,
    compute_permutation: bool = True,
    clamp_db: Optional[float] = None,
):
    """fast_bss_eval.si_bss_eval_sources-compatible API.

    ref, est: (batch, n_src, T) numpy arrays
    Returns (si_sdr, si_sir, si_sar, perm) each (batch, n_src); outputs are
    ordered by reference index, and est[:, perm[b]] aligns est with ref.
    """
    ref = np.asarray(ref, np.float64)
    est = np.asarray(est, np.float64)
    if ref.ndim == 2:
        ref, est = ref[None], est[None]
    if zero_mean:
        ref = ref - ref.mean(-1, keepdims=True)
        est = est - est.mean(-1, keepdims=True)

    b, n, _ = ref.shape
    out_sdr = np.zeros((b, n))
    out_sir = np.zeros((b, n))
    out_sar = np.zeros((b, n))
    out_perm = np.zeros((b, n), np.int64)
    perms = list(itertools.permutations(range(n)))

    for bi in range(b):
        sdr, sir, sar = _project_decompose(ref[bi], est[bi])
        sdr_db = _db(sdr, clamp_db)
        if compute_permutation:
            scores = [sum(sdr_db[i, p[i]] for i in range(n)) for p in perms]
            best = perms[int(np.argmax(scores))]
        else:
            best = tuple(range(n))
        idx = np.asarray(best)
        out_sdr[bi] = sdr_db[np.arange(n), idx]
        out_sir[bi] = _db(sir, clamp_db)[np.arange(n), idx]
        out_sar[bi] = _db(sar, clamp_db)[np.arange(n), idx]
        out_perm[bi] = idx
    return out_sdr, out_sir, out_sar, out_perm


# --------------------------------------------------------------------------
# STOI (Taal et al. 2011) / extended STOI (Jensen & Taal 2016)
# --------------------------------------------------------------------------
_FS_STOI = 10000
_N_FRAME = 256
_N_FFT = 512
_NUM_BANDS = 15
_MIN_FREQ = 150.0
_SEG_LEN = 30  # analysis segment length in frames (384 ms)
_BETA_DB = -15.0  # SDR clip for standard STOI
_DYN_RANGE = 40.0  # silent-frame removal threshold


def _third_octave_bands(fs: int, n_fft: int, num_bands: int, min_freq: float):
    f = np.linspace(0, fs, n_fft, endpoint=False)[: n_fft // 2 + 1]
    k = np.arange(num_bands)
    cf = min_freq * 2.0 ** (k / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    H = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo_i = np.argmin((f - lo[i]) ** 2)
        hi_i = np.argmin((f - hi[i]) ** 2)
        H[i, lo_i:hi_i] = 1.0
    return H


def _stft_frames(x: np.ndarray):
    w = np.hanning(_N_FRAME + 2)[1:-1]
    n_frames = (len(x) - _N_FRAME) // (_N_FRAME // 2) + 1
    idx = (
        np.arange(_N_FRAME)[None, :]
        + np.arange(n_frames)[:, None] * (_N_FRAME // 2)
    )
    frames = x[idx] * w
    return np.fft.rfft(frames, n=_N_FFT, axis=-1)


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    w = np.hanning(_N_FRAME + 2)[1:-1]
    hop = _N_FRAME // 2
    n_frames = (len(x) - _N_FRAME) // hop + 1
    idx = np.arange(_N_FRAME)[None, :] + np.arange(n_frames)[:, None] * hop
    xf = x[idx] * w
    yf = y[idx] * w
    energy = 20.0 * np.log10(np.linalg.norm(xf, axis=-1) + _EPS)
    mask = energy > (energy.max() - _DYN_RANGE)
    xf, yf = xf[mask], yf[mask]
    # overlap-add back
    n = len(xf)
    out_len = (n - 1) * hop + _N_FRAME if n else 0
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    for i in range(n):
        xs[i * hop : i * hop + _N_FRAME] += xf[i]
        ys[i * hop : i * hop + _N_FRAME] += yf[i]
    return xs, ys


def _estoi_segment_d(Xs: np.ndarray, Ys: np.ndarray) -> np.ndarray:
    """Extended-STOI intermediate intelligibility per segment.

    Xs, Ys: (bands, n_seg, seg_len) clean/degraded band envelopes.
    Jensen & Taal 2016 eq. (5): row-normalize over time, column-normalize
    over bands, then d_m = (1/N) sum_n x_n^T y_n over the N time columns
    (pystoi divides by N, not by the band count; identical signals must
    score exactly 1.0 — regression-tested, and the stage is anchored by
    hand-computed cases in tests/test_metrics.py)."""

    def _norm(a, axis):
        c = a - a.mean(axis, keepdims=True)
        return c / (np.linalg.norm(c, axis=axis, keepdims=True) + _EPS)

    Xn = _norm(_norm(Xs, 2), 0)
    Yn = _norm(_norm(Ys, 2), 0)
    return np.sum(Xn * Yn, axis=(0, 2)) / Xs.shape[2]  # (n_seg,)


def _stoi_segment_d(Xs: np.ndarray, Ys: np.ndarray) -> np.ndarray:
    """Standard-STOI intermediate measure per (band, segment).

    Taal et al. 2011: per segment, scale the degraded envelope to the
    clean energy, clip at (1 + 10^(-beta/20)) times the clean envelope,
    then correlate. Returns the per-segment band-mean d (n_seg,)."""
    alpha = np.linalg.norm(Xs, axis=2, keepdims=True) / (
        np.linalg.norm(Ys, axis=2, keepdims=True) + _EPS
    )
    Yc = np.minimum(Ys * alpha, Xs * (1.0 + 10.0 ** (-_BETA_DB / 20.0)))
    xm = Xs - Xs.mean(2, keepdims=True)
    ym = Yc - Yc.mean(2, keepdims=True)
    d = np.sum(xm * ym, axis=2) / (
        np.linalg.norm(xm, axis=2) * np.linalg.norm(ym, axis=2) + _EPS
    )
    return d.mean(axis=0)  # (n_seg,)


def stoi(ref, est, fs: int, extended: bool = False) -> float:
    """Short-Time Objective Intelligibility of `est` against clean `ref`."""
    from scipy.signal import resample_poly

    ref = np.asarray(ref, np.float64).ravel()
    est = np.asarray(est, np.float64).ravel()
    if fs != _FS_STOI:
        g = np.gcd(int(fs), _FS_STOI)
        ref = resample_poly(ref, _FS_STOI // g, fs // g)
        est = resample_poly(est, _FS_STOI // g, fs // g)

    ref, est = _remove_silent_frames(ref, est)
    if len(ref) < _N_FRAME * 2:
        return np.nan

    H = _third_octave_bands(_FS_STOI, _N_FFT, _NUM_BANDS, _MIN_FREQ)
    X = np.sqrt(H @ (np.abs(_stft_frames(ref)) ** 2).T + _EPS)  # (bands, frames)
    Y = np.sqrt(H @ (np.abs(_stft_frames(est)) ** 2).T + _EPS)
    if X.shape[1] < _SEG_LEN:
        return np.nan

    # All sliding segments at once: (bands, n_seg, SEG_LEN). The per-segment
    # math below is the straight vectorization of the published per-m loop
    # (golden-anchored in tests/test_metrics.py against an independent
    # per-segment transcription to 1e-9).
    Xs = np.ascontiguousarray(
        np.lib.stride_tricks.sliding_window_view(X, _SEG_LEN, axis=1)
    )
    Ys = np.ascontiguousarray(
        np.lib.stride_tricks.sliding_window_view(Y, _SEG_LEN, axis=1)
    )
    corrs = (
        _estoi_segment_d(Xs, Ys) if extended else _stoi_segment_d(Xs, Ys)
    )
    return float(np.mean(corrs))
