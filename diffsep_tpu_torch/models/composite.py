"""Composite speech-quality metrics CSIG / CBAK / COVL (Hu & Loizou 2008).

Counterpart of ``diffsep_tpu/models/composite.py``, a numpy copy (the port
imports nothing of the JAX package): the weighted spectral slope (WSS), the
log-likelihood ratio (LLR, from LPC by Levinson-Durbin), the segmental SNR,
and the composite regressions over them and PESQ, on 30 ms frames with 75%
overlap and the measure's Hann-like window. PESQ is the port's own
``models/pesq_native.py`` (wide band at 16 kHz, narrow band otherwise);
where PESQ fails (a silent clip), the WSS, LLR and SSNR terms are returned
with NaN composites. The accumulation orders are the JAX package's, which
pinned them to the reference implementation: the LPC's autocorrelations as
elementwise sums, the LLR's quadratic forms as per-frame float32 products.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = [
    "eval_composite", "wss", "llr", "ssnr", "lpcoeff", "lpcoeff_frames",
    "trim_mos",
]

# critical band center frequencies / bandwidths (Hz) for the WSS measure
_CENT_FREQ = np.array([
    50.0, 120, 190, 260, 330, 400, 470, 540, 617.372, 703.378, 798.717,
    904.128, 1020.38, 1148.30, 1288.72, 1442.54, 1610.70, 1794.16, 1993.93,
    2211.08, 2446.71, 2701.97, 2978.04, 3276.17, 3597.63,
])
_BANDWIDTH = np.array([
    70.0, 70, 70, 70, 70, 70, 70, 77.3724, 86.0056, 95.3398, 105.411,
    116.256, 127.914, 140.423, 153.823, 168.154, 183.457, 199.776, 217.153,
    235.631, 255.255, 276.072, 298.126, 321.465, 346.136,
])


def trim_mos(v: float) -> float:
    return float(min(max(v, 1.0), 5.0))


def _frames(x: np.ndarray, winlength: int, skiprate: int) -> np.ndarray:
    n = int(len(x) / skiprate - winlength / skiprate)
    idx = np.arange(winlength)[None, :] + skiprate * np.arange(n)[:, None]
    t = np.arange(1, winlength + 1) / (winlength + 1)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * t))
    return x[idx] * window


def lpcoeff_frames(frames: np.ndarray, order: int):
    """Autocorrelation + Levinson-Durbin LPC, batched over frames.

    frames: (n_frames, winlength). Returns (R, rc, lp) shaped
    (n_frames, order+1), (n_frames, order), (n_frames, order+1) — per frame
    the autocorr lags R[0..order], reflection coeffs, [1, -a_1..-a_p].

    np.sum of the elementwise product (NOT np.dot/BLAS): the LPC recursion
    is ill-conditioned when reflection coefficients approach +-1, and the
    different accumulation order of BLAS dot vs pairwise sum diverges by
    whole digits after ~8 recursion steps. Batching over the leading axis
    keeps each frame's accumulation identical to the scalar formulation
    (contiguous last-axis pairwise sums).
    """
    frames = np.ascontiguousarray(frames, np.float64)
    nf, n = frames.shape
    R = np.empty((nf, order + 1))
    for k in range(order + 1):
        R[:, k] = np.sum(frames[:, : n - k] * frames[:, k:], axis=1)

    a = np.zeros((nf, order))
    E = R[:, 0].copy()
    rc = np.zeros((nf, order))
    for i in range(order):
        acc = R[:, i + 1] - np.sum(a[:, :i] * R[:, i:0:-1], axis=1)
        k = acc / np.maximum(1e-15, E)
        rc[:, i] = k
        a[:, :i] = a[:, :i] - k[:, None] * a[:, :i][:, ::-1]
        a[:, i] = k
        E = (1.0 - k * k) * E
    lp = np.concatenate((np.ones((nf, 1)), -a), axis=1).astype(np.float32)
    return R.astype(np.float32), rc.astype(np.float32), lp


def lpcoeff(frame: np.ndarray, order: int):
    """Single-frame LPC; see lpcoeff_frames."""
    R, rc, lp = lpcoeff_frames(np.asarray(frame)[None, :], order)
    return R[0], rc[0], lp[0]


def ssnr(ref: np.ndarray, deg: np.ndarray, fs: int = 16000, eps: float = 1e-10):
    """(overall SNR, per-frame segmental SNR clipped to [-10, 35] dB)."""
    ref = ref - ref.mean()
    deg = deg - deg.mean()
    deg = deg * (np.max(np.abs(ref)) / max(np.max(np.abs(deg)), 1e-20))

    dif = ref - deg
    overall = 10 * np.log10(np.sum(ref**2) / (np.sum(dif**2) + 1e-19))

    winlength = int(round(30 * fs / 1000))
    skiprate = winlength // 4
    fr = _frames(ref, winlength, skiprate)
    fd = _frames(deg, winlength, skiprate)
    sig = np.sum(fr**2, axis=1)
    noise = np.sum((fr - fd) ** 2, axis=1)
    seg = 10 * np.log10(sig / (noise + eps) + eps)
    return overall, np.clip(seg, -10.0, 35.0)


def _crit_filters(fs: int, n_fftby2: int) -> np.ndarray:
    max_freq = fs / 2
    min_factor = np.exp(-30.0 / (2 * 2.303))
    f0 = np.floor(_CENT_FREQ / max_freq * n_fftby2)[:, None]
    bw = (_BANDWIDTH / max_freq * n_fftby2)[:, None]
    norm = (np.log(_BANDWIDTH[0]) - np.log(_BANDWIDTH))[:, None]
    j = np.arange(n_fftby2)[None, :]
    filt = np.exp(-11.0 * ((j - f0) / bw) ** 2 + norm)
    return filt * (filt > min_factor)


def wss(ref: np.ndarray, deg: np.ndarray, fs: int = 16000) -> np.ndarray:
    """Per-frame weighted spectral slope distances."""
    assert len(ref) == len(deg)
    winlength = round(30 * fs / 1000.0)
    skiprate = int(np.floor(winlength / 4))
    n_fft = int(2 ** np.ceil(np.log2(2 * winlength)))
    n_fftby2 = n_fft // 2
    Kmax, Klocmax = 20.0, 1.0
    num_crit = len(_CENT_FREQ)

    filt = _crit_filters(fs, n_fftby2)
    fr = _frames(ref, winlength, skiprate)
    fd = _frames(deg, winlength, skiprate)
    spec_r = np.abs(np.fft.fft(fr, n_fft, axis=1)[:, :n_fftby2]) ** 2
    spec_d = np.abs(np.fft.fft(fd, n_fft, axis=1)[:, :n_fftby2]) ** 2
    e_r = 10 * np.log10(np.maximum(spec_r @ filt.T, 1e-10))  # (frames, crit)
    e_d = 10 * np.log10(np.maximum(spec_d @ filt.T, 1e-10))

    def loc_peaks(energy, slope):
        """The nearest peak in the slope's direction, all frames and bands
        at once: a rising slope walks forward to the first non-positive
        slope n and takes energy[n-1]; a falling one walks back to the first
        positive slope n and takes energy[n+1], the measure's indexing."""
        nf, nb = slope.shape  # (frames, num_crit - 1)
        ar = np.arange(nb)[None, :]
        pos = slope > 0
        # next index >= i with non-positive slope (or nb if none)
        nxt = np.where(~pos, ar, nb)
        nxt = np.minimum.accumulate(nxt[:, ::-1], axis=1)[:, ::-1]
        # previous index <= i with positive slope (or -1 if none)
        prv = np.where(pos, ar, -1)
        prv = np.maximum.accumulate(prv, axis=1)
        rows = np.arange(nf)[:, None]
        up = energy[rows, np.maximum(nxt - 1, 0)]
        down = energy[rows, prv + 1]
        return np.where(pos, up, down)

    cs = np.diff(e_r, axis=1)
    ps = np.diff(e_d, axis=1)
    cp = loc_peaks(e_r, cs)
    pp = loc_peaks(e_d, ps)
    ce = e_r[:, :-1]
    pe = e_d[:, :-1]
    Wc = (Kmax / (Kmax + e_r.max(1, keepdims=True) - ce)) * (
        Klocmax / (Klocmax + cp - ce)
    )
    Wp = (Kmax / (Kmax + e_d.max(1, keepdims=True) - pe)) * (
        Klocmax / (Klocmax + pp - pe)
    )
    W = 0.5 * (Wc + Wp)
    return np.sum(W * (cs - ps) ** 2, axis=1) / np.sum(W, axis=1)


def llr(ref: np.ndarray, deg: np.ndarray, fs: int = 16000) -> np.ndarray:
    """Per-frame log-likelihood ratio."""
    assert len(ref) == len(deg)
    winlength = round(30 * fs / 1000.0)
    skiprate = int(np.floor(winlength / 4))
    order = 10 if fs < 10000 else 16

    fr = _frames(ref, winlength, skiprate)
    fd = _frames(deg, winlength, skiprate)
    R_c, _, A_c = lpcoeff_frames(fr, order)
    _, _, A_p = lpcoeff_frames(fd, order)
    # The quadratic forms stay per-frame float32 products (gemv + dot) on
    # purpose: LPC whitening makes A^T T A cancellation-dominated on
    # near-silent frames, where the result is rounding, so the same float32
    # accumulation gives the same result and a float64 one does not
    idx = np.abs(np.arange(order + 1)[:, None] - np.arange(order + 1)[None, :])
    # contiguous, so that each T[i] takes one accumulation path (a strided
    # T takes another, which on those frames changes the result)
    T = np.ascontiguousarray(R_c[:, idx])  # (frames, p+1, p+1) f32
    out = np.empty(fr.shape[0])
    for i in range(fr.shape[0]):
        num = max(float(A_p[i] @ T[i] @ A_p[i]), 1e-10)
        den = max(float(A_c[i] @ T[i] @ A_c[i]), 1e-10)
        out[i] = np.log(num / den)
    return np.nan_to_num(out)


def eval_composite(
    ref_wav: np.ndarray,
    deg_wav: np.ndarray,
    fs: int = 16000,
    alpha: float = 0.95,
    pesq_value: Optional[float] = None,
) -> Dict[str, float]:
    """CSIG/CBAK/COVL composites of a degraded signal against its
    reference, with the WSS, LLR, segmental SNR and PESQ they are made of.

    The trimmed means keep the best `alpha` fraction of frames, as in the
    original measure. `pesq_value` may be precomputed; otherwise
    ``models/pesq_native.py`` computes it; where that fails the composites
    are NaN.
    """
    ref = np.asarray(ref_wav, np.float64).reshape(-1)
    deg = np.asarray(deg_wav, np.float64).reshape(-1)
    n = min(len(ref), len(deg))
    ref, deg = ref[:n].copy(), deg[:n].copy()

    wss_vec = np.sort(wss(ref, deg, fs))
    wss_mean = float(np.mean(wss_vec[: int(round(len(wss_vec) * alpha))]))

    llr_vec = np.sort(llr(ref, deg, fs))
    llr_mean = float(np.mean(llr_vec[: int(round(len(llr_vec) * alpha))]))

    _, seg = ssnr(ref, deg, fs)
    seg_snr = float(np.mean(seg))

    if pesq_value is None:
        try:
            from .pesq_native import get_pesq

            # wb requires 16 kHz (P.862.2); fall back to nb for 8 kHz data
            mode = "wb" if fs == 16000 else "nb"
            pesq_value = float(get_pesq()(fs, ref, deg, mode))
        except Exception:
            # a PESQ failure (a short or silent clip, an unsupported rate)
            # gives NaN composites and does not end the evaluation
            pesq_value = float("nan")

    csig = 3.093 - 1.029 * llr_mean + 0.603 * pesq_value - 0.009 * wss_mean
    cbak = 1.634 + 0.478 * pesq_value - 0.007 * wss_mean + 0.063 * seg_snr
    covl = 1.594 + 0.805 * pesq_value - 0.512 * llr_mean - 0.007 * wss_mean
    finite = np.isfinite(pesq_value)
    return {
        "csig": trim_mos(csig) if finite else float("nan"),
        "cbak": trim_mos(cbak) if finite else float("nan"),
        "covl": trim_mos(covl) if finite else float("nan"),
        "wss": wss_mean,
        "llr": llr_mean,
        "ssnr": seg_snr,
        "pesq": pesq_value,
    }
