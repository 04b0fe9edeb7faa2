"""Native PESQ (ITU-T P.862 / P.862.2 structure), numpy only.

The port's own copy of ``diffsep_tpu/models/pesq_native.py``, the same
function to the last bit: the noise-reduction recipe selects checkpoints on
``val/pesq`` and evaluation reports per-utterance ``pesq``. The pipeline:

  level alignment (-> 1e7 target power in the 350-3250 Hz band)
  -> receive-characteristic filter (IRS for nb, 100 Hz high-pass for wb)
  -> time alignment (envelope cross-correlation, single global delay)
  -> perceptual model: Hann frames at 50% overlap -> power spectrum
     -> Bark-band integration -> partial gain/frequency compensation
     -> Zwicker loudness -> masked disturbance + asymmetric disturbance
  -> L6-over-chunks / L2-over-time aggregation
  -> raw = 4.5 - 0.1*d_sym - 0.0309*d_asym
  -> MOS-LQO mapping (P.862.1 nb / P.862.2 wb sigmoids)

Conformance: the structure follows the published standard, but the Bark
band edges and absolute-threshold tables are analytic (7 asinh(f/650) bark
scale, Terhardt threshold curve) instead of the ITU tables, and the fine
per-frame alignment histogram is replaced by direct cross-correlation.
Scores are exact for identical signals (4.549 nb / 4.644 wb) and monotonic
for degraded speech, but NOT bit-conformant to the ITU implementation.
Where the GPL `pesq` package is installed it takes precedence (`get_pesq`).

Use `get_pesq()` everywhere instead of importing the package directly.
"""
from __future__ import annotations

import numpy as np

__all__ = ["pesq", "get_pesq", "NativePesqError"]


class NativePesqError(ValueError):
    pass


# --------------------------------------------------------------------------
# configuration per sample rate
# --------------------------------------------------------------------------

_CFG = {
    # 32 ms frames at 50% overlap — the P.862 geometry
    8000: dict(nfft=256, downsample=32, n_bark=42),
    16000: dict(nfft=512, downsample=64, n_bark=49),
}

_TARGET_POWER = 1e7

# calibration constants (identity-invariant): absolute threshold at 1 kHz
# in band-density units, the Zwicker loudness scale, and the asymmetric
# frame-disturbance cap, as the JAX package fits them (its
# tests/test_pesq_native.py); the residual curve-shape mismatch against the
# ITU implementation is structural (analytic Bark/threshold tables).
_P0_1K = 0.1
_SL = 1.5
_ASYM_CAP = 90.0

# IRS receive characteristic (frequency Hz, gain dB) — telephone-band
# weighting applied in narrowband mode (P.862 standard IRS filter shape)
_IRS_DB = np.array([
    (0, -200.0), (50, -40.0), (100, -20.0), (125, -12.0), (160, -6.0),
    (200, 0.0), (250, 4.0), (300, 6.0), (350, 8.0), (400, 10.0),
    (500, 11.0), (600, 12.0), (700, 12.0), (800, 12.0), (1000, 12.0),
    (1300, 12.0), (1600, 12.0), (2000, 12.0), (2500, 12.0), (3000, 12.0),
    (3250, 12.0), (3500, 4.0), (4000, -200.0), (8000, -200.0),
])


def _bark(f):
    return 7.0 * np.arcsinh(np.asarray(f, np.float64) / 650.0)


def _abs_threshold_db(f_hz):
    """Terhardt absolute hearing threshold (dB SPL-like), clipped."""
    f = np.maximum(np.asarray(f_hz, np.float64), 20.0) / 1000.0
    thr = (
        3.64 * f**-0.8
        - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
        + 1e-3 * f**4
    )
    return np.clip(thr, -10.0, 100.0)


def _band_partition(fs, nfft, n_bark):
    """Assign rFFT bins (excluding DC) to n_bark contiguous bands uniform
    on the bark axis; guarantees every band holds >= 1 bin."""
    freqs = np.fft.rfftfreq(nfft, 1.0 / fs)[1:]
    z = _bark(freqs)
    edges = np.linspace(0.0, float(z[-1]) + 1e-9, n_bark + 1)
    idx = np.clip(np.searchsorted(edges, z, side="right") - 1, 0, n_bark - 1)
    # guarantee non-empty bands: walk once, folding empties downward
    counts = np.bincount(idx, minlength=n_bark)
    if (counts == 0).any():
        # re-partition by splitting the bin list into n_bark runs of at
        # least one bin, proportional to bark coverage
        cum = (z - z[0]) / (z[-1] - z[0] + 1e-12)
        idx = np.minimum((cum * n_bark).astype(int), n_bark - 1)
        # make monotone starts unique
        for b in range(1, n_bark):
            if not (idx == b).any():
                first = np.searchsorted(idx, b)
                if first >= len(idx):
                    first = len(idx) - 1
                idx[first] = b
        idx = np.maximum.accumulate(idx)
    centers_hz = np.array(
        [freqs[idx == b].mean() for b in range(n_bark)]
    )
    widths_bark = np.array(
        [
            max(_bark(freqs[idx == b].max()) - _bark(freqs[idx == b].min()), 1e-3)
            if (idx == b).sum() > 1
            else edges[b + 1] - edges[b]
            for b in range(n_bark)
        ]
    )
    return idx, centers_hz, widths_bark


def _level_align(x, fs):
    """Scale so the 350-3250 Hz band power equals the P.862 target."""
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1.0 / fs)
    band = (freqs >= 350) & (freqs <= 3250)
    # Parseval: band energy -> mean band power per sample
    p = (np.abs(spec[band]) ** 2).sum() * 2.0 / (len(x) ** 2)
    if p <= 0:
        raise NativePesqError("silent input signal")
    return x * np.sqrt(_TARGET_POWER / (p * len(x)))


def _apply_fft_filter(x, fs, curve_hz, curve_db):
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1.0 / fs)
    gain_db = np.interp(freqs, curve_hz, curve_db)
    spec *= 10.0 ** (gain_db / 20.0)
    return np.fft.irfft(spec, n=len(x))


def _input_filter(x, fs, mode):
    if mode == "nb":
        return _apply_fft_filter(x, fs, _IRS_DB[:, 0], _IRS_DB[:, 1])
    # wb: 100 Hz high-pass roll-off (P.862.2 input filter intent)
    return _apply_fft_filter(
        x, fs,
        np.array([0.0, 50.0, 100.0, fs / 2]),
        np.array([-200.0, -20.0, 0.0, 0.0]),
    )


def _global_delay(ref, deg, downsample):
    """Crude alignment: cross-correlate block-energy envelopes."""
    def env(x):
        n = len(x) // downsample
        e = np.abs(x[: n * downsample]).reshape(n, downsample).sum(axis=1)
        return np.log(e + 1e-10)

    a, b = env(ref), env(deg)
    n = 1 << int(np.ceil(np.log2(len(a) + len(b))))
    corr = np.fft.irfft(
        np.fft.rfft(b - b.mean(), n) * np.conj(np.fft.rfft(a - a.mean(), n)), n
    )
    lags = np.arange(n)
    lags[lags > n // 2] -= n
    best = int(lags[np.argmax(corr)])
    return best * downsample  # deg is delayed by this many samples


def _frames(x, nfft):
    hop = nfft // 2
    n = max((len(x) - nfft) // hop + 1, 0)
    if n == 0:
        return np.zeros((0, nfft))
    idx = np.arange(nfft)[None, :] + hop * np.arange(n)[:, None]
    return x[idx]


_SILENCE_GAP_S = 0.2  # min silence separating utterances
_MIN_UTT_S = 0.3  # shorter active spans are merged/ignored


def _split_utterances(ref, fs):
    """Active-speech utterance spans of the (level-aligned) reference:
    4 ms block energies, -35 dB activity threshold, gaps shorter than
    200 ms closed, spans shorter than 300 ms folded into neighbours.
    Mirrors P.862's utterance segmentation stage; returns sample spans."""
    block = max(fs // 250, 8)  # 4 ms
    n = len(ref) // block
    if n == 0:
        return [(0, len(ref))]
    e = (ref[: n * block].reshape(n, block) ** 2).sum(axis=1)
    db = 10.0 * np.log10(e + 1e-10)
    act = db > db.max() - 35.0
    # spans of consecutive active blocks
    spans = []
    start = None
    for i, a in enumerate(act):
        if a and start is None:
            start = i
        elif not a and start is not None:
            spans.append([start, i])
            start = None
    if start is not None:
        spans.append([start, n])
    if not spans:
        return [(0, len(ref))]
    # close short silence gaps
    gap = max(int(round(_SILENCE_GAP_S * fs / block)), 1)
    merged = [spans[0]]
    for s, e_ in spans[1:]:
        if s - merged[-1][1] < gap:
            merged[-1][1] = e_
        else:
            merged.append([s, e_])
    # drop spans that stayed too short (noise blips)
    min_utt = max(int(round(_MIN_UTT_S * fs / block)), 1)
    merged = [se for se in merged if se[1] - se[0] >= min_utt] or [
        [0, n]
    ]
    # one-block margin, converted to samples
    out = []
    for s, e_ in merged:
        out.append((max(s - 1, 0) * block, min(e_ + 1, n) * block))
    return out


def _refine_delay(ref_span, deg, d0, start, end, max_shift):
    """Best local delay for deg against ref[start:end], searched in
    d0 +- max_shift by direct cross-correlation (replaces P.862's framewise
    correlation histogram). Returns the refined delay."""
    lo = start + d0 - max_shift
    seg_len = (end - start) + 2 * max_shift
    pad_l = max(-lo, 0)
    a = deg[max(lo, 0) : max(lo + seg_len, 0)]
    seg = np.zeros(seg_len)
    seg[pad_l : pad_l + len(a)] = a[: max(seg_len - pad_l, 0)]
    r = ref_span - ref_span.mean()
    s = seg - seg.mean()
    n = 1 << int(np.ceil(np.log2(len(s) + len(r))))
    corr = np.fft.irfft(np.fft.rfft(s, n) * np.conj(np.fft.rfft(r, n)), n)
    # lag k means deg[start + d0 - max_shift + k + i] ~ ref[start + i]
    valid = corr[: 2 * max_shift + 1]
    k = int(np.argmax(np.abs(valid)))
    return d0 - max_shift + k


def _utterance_frames(x, start, delay, n_frames, nfft):
    """Frames of x for one utterance at the given delay, zero-padded where
    the delayed span runs off either end of the signal."""
    hop = nfft // 2
    out = np.zeros((n_frames, nfft))
    for i in range(n_frames):
        s = start + delay + i * hop
        e = s + nfft
        cs, ce = max(s, 0), min(e, len(x))
        if ce > cs:
            out[i, cs - s : cs - s + (ce - cs)] = x[cs:ce]
    return out


def pesq(fs: int, ref, deg, mode: str = "wb") -> float:
    """MOS-LQO, signature-compatible with `pesq.pesq` from the package."""
    if mode not in ("nb", "wb"):
        raise NativePesqError(f"mode must be 'nb' or 'wb', got {mode!r}")
    if fs not in _CFG:
        raise NativePesqError(f"fs must be 8000 or 16000, got {fs}")
    if mode == "wb" and fs != 16000:
        raise NativePesqError("wideband PESQ requires fs=16000")

    ref = np.asarray(ref, np.float64).reshape(-1)
    deg = np.asarray(deg, np.float64).reshape(-1)
    n = min(len(ref), len(deg))
    if n < fs // 4:
        raise NativePesqError("signals too short for PESQ (<250 ms)")
    ref, deg = ref[:n].copy(), deg[:n].copy()

    cfg = _CFG[fs]
    nfft, n_bark = cfg["nfft"], cfg["n_bark"]

    ref = _level_align(ref, fs)
    deg = _level_align(deg, fs)
    ref = _input_filter(ref, fs, mode)
    deg = _input_filter(deg, fs, mode)

    hop = nfft // 2
    band_idx, centers_hz, widths = _band_partition(fs, nfft, n_bark)
    win = np.hanning(nfft)

    # crude whole-signal delay, then per-utterance refinement (P.862's
    # utterance-by-utterance alignment stage). Utterance spans drive the
    # ALIGNMENT only — every frame of the whole signal is scored,
    # including silence gaps (added noise in pauses is exactly what the
    # metric must punish); gap frames inherit the delay of the preceding
    # utterance (crude before the first).
    crude = _global_delay(ref, deg, cfg["downsample"])
    max_shift = max(fs // 40, hop)  # 25 ms refinement window
    utt_delays = []  # (start_sample, delay); applies until the next start
    for (s, e) in _split_utterances(ref, fs):
        if e - s >= nfft:
            utt_delays.append(
                (s, _refine_delay(ref[s:e], deg, crude, s, e, max_shift))
            )
    n_frames_total = max((len(ref) - nfft) // hop + 1, 0)
    if n_frames_total < 2:
        raise NativePesqError("signals too short after alignment")
    frame_meta = []  # per frame: (ref start sample, delay)
    for i in range(n_frames_total):
        p = i * hop
        d = crude
        for (s, d_u) in utt_delays:
            if s <= p:
                d = d_u  # last utterance starting at or before this frame
            else:
                break
        frame_meta.append((p, d))
    # reference frames are delay-0 at p = i*hop: exactly _frames
    fr = _frames(ref, nfft)[:n_frames_total] * win
    # degraded frames per constant-delay run (one vector build per
    # utterance-delay run instead of one Python call per frame)
    fd = np.empty_like(fr)
    i = 0
    while i < n_frames_total:
        j = i
        while j < n_frames_total and frame_meta[j][1] == frame_meta[i][1]:
            j += 1
        fd[i:j] = _utterance_frames(
            deg, i * hop, frame_meta[i][1], j - i, nfft
        )
        i = j
    fd *= win

    # power spectra (exclude DC) -> bark band powers, normalized to a
    # density-like scale so thresholds are comparable across band widths
    scale = 1.0 / (widths * nfft)

    def band_powers(frames):
        p = np.abs(np.fft.rfft(frames, axis=1))[:, 1:] ** 2
        bp = np.zeros((p.shape[0], n_bark))
        for b in range(n_bark):
            bp[:, b] = p[:, band_idx == b].sum(axis=1)
        return bp * scale

    br = band_powers(fr)
    bd = band_powers(fd)

    # anchor to P.862 working units: the standard's absolute constants
    # (+50 asymmetry floor, +1e5 frame weighting, 1e7 level target) assume
    # active-speech frame power ~ 1e7. Self-calibrate from the reference
    # so every constant below operates in its intended regime.
    tot0 = br.sum(axis=1)
    act0 = tot0 > tot0.max() * 1e-3 + 1e-12
    c = _TARGET_POWER / max(float(tot0[act0].mean()), 1e-12)
    br *= c
    bd *= c

    # absolute threshold per band: Terhardt curve anchored at _P0_1K at
    # 1 kHz (calibrated, see module docstring)
    thr_db = _abs_threshold_db(centers_hz)
    p0 = 10.0 ** ((thr_db - _abs_threshold_db(1000.0)) / 10.0) * _P0_1K

    # speech-active frames: audible reference power above threshold
    tot_r = br.sum(axis=1)
    active = tot_r > (tot_r.max() * 1e-3 + 1e-12)
    if not active.any():
        active = np.ones(len(tot_r), bool)

    # partial frequency (gain) compensation of the degraded spectrum
    mean_r = br[active].mean(axis=0)
    mean_d = bd[active].mean(axis=0)
    bd_eq = bd * np.clip(
        (mean_r + 1000.0) / (mean_d + 1000.0), 10 ** (-2.0), 10 ** (2.0)
    )

    # per-frame gain compensation (first-order smoothed, clipped). The
    # gain is a SPEECH gain estimate: it only updates while the reference
    # is active and holds through pauses — otherwise it would track the
    # degraded signal's noise floor down and cancel exactly the
    # added-noise-in-silence disturbance PESQ is designed to punish.
    ratio = (br.sum(axis=1) + 5e3) / (bd_eq.sum(axis=1) + 5e3)
    g = np.empty_like(ratio)
    acc = 1.0
    for i, r in enumerate(ratio):
        if active[i]:
            acc = 0.8 * acc + 0.2 * np.clip(r, 3e-4, 5.0)
        g[i] = np.clip(acc, 3e-4, 5.0)
    bd_eq = bd_eq * g[:, None]

    # Zwicker loudness
    def loudness(p):
        sl = _SL  # loudness scale (identity-invariant; calibrated)
        base = (p0 / 0.5) ** 0.23
        ratio = (0.5 + 0.5 * p / p0) ** 0.23 - 1.0
        s = sl * base * ratio
        return np.where(p > p0, s, 0.0)

    w = widths / widths.sum()

    def disturbance(br_rows, bd_eq_rows):
        """Masked symmetric + asymmetric frame disturbances (unweighted)."""
        lr = loudness(br_rows)
        ld = loudness(bd_eq_rows)
        d = ld - lr
        m = 0.25 * np.minimum(lr, ld)
        dist = np.sign(d) * np.maximum(np.abs(d) - m, 0.0)
        h = ((bd_eq_rows + 50.0) / (br_rows + 50.0)) ** 1.2
        h = np.where(h < 3.0, 0.0, np.minimum(h, 12.0))
        f_sym = np.sqrt((w * dist**2).sum(axis=1))
        f_asym = (w * np.abs(dist) * h).sum(axis=1)
        return f_sym, f_asym

    frame_sym, frame_asym = disturbance(br, bd_eq)

    # bad-interval realignment (P.862: intervals whose frame disturbance
    # exceeds the bad-frame threshold are re-searched for a better local
    # delay; the realignment that lowers the disturbance wins)
    bad = frame_sym > 45.0
    i = 0
    while i < n_frames_total:
        if not bad[i]:
            i += 1
            continue
        j = i
        # run of consecutive bad frames sharing one alignment delay
        while (
            j < n_frames_total
            and bad[j]
            and frame_meta[j][1] == frame_meta[i][1]
        ):
            j += 1
        start_r, d_u = frame_meta[i]
        end_r = frame_meta[j - 1][0] + nfft
        d_new = _refine_delay(
            ref[start_r:end_r], deg, d_u, start_r, end_r,
            max(int(0.032 * fs), hop),
        )
        if d_new != d_u:
            n_run = j - i
            fd_new = (
                _utterance_frames(deg, start_r, d_new, n_run, nfft) * win
            )
            bd_new = band_powers(fd_new) * c
            bd_eq_new = bd_new * np.clip(
                (mean_r + 1000.0) / (mean_d + 1000.0),
                10 ** (-2.0), 10 ** (2.0),
            ) * g[i:j, None]
            sym_new, asym_new = disturbance(br[i:j], bd_eq_new)
            better = sym_new < frame_sym[i:j]
            frame_sym[i:j] = np.where(better, sym_new, frame_sym[i:j])
            frame_asym[i:j] = np.where(better, asym_new, frame_asym[i:j])
        i = j

    # weight frames by audible reference power, clip spikes
    fw = ((tot_r + 1e5) / 1e7) ** 0.04
    frame_sym = np.minimum(frame_sym / fw, 45.0)
    frame_asym = np.minimum(frame_asym / fw, _ASYM_CAP)

    def aggregate(fd_, chunk=20):
        # L6 inside ~320 ms windows, L2 across windows (P.862 time norms)
        n = len(fd_)
        if n == 0:
            return 0.0
        pad = (-n) % chunk
        x = np.pad(fd_, (0, pad))
        blocks = x.reshape(-1, chunk)
        l6 = ((blocks**6).mean(axis=1)) ** (1 / 6)
        return float(np.sqrt((l6**2).mean()))

    d_sym = aggregate(frame_sym)
    d_asym = aggregate(frame_asym)

    raw = 4.5 - 0.1 * d_sym - 0.0309 * d_asym

    if mode == "nb":
        mos = 0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607))
    else:
        mos = 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224))
    return float(np.clip(mos, 1.0, 4.999))


def get_pesq():
    """The PESQ callable to use: the reference GPL `pesq` package when
    installed (bit-conformant), else this module's native implementation."""
    try:
        from pesq import pesq as _pkg_pesq  # type: ignore

        return _pkg_pesq
    except ImportError:
        return pesq
