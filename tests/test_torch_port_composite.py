"""The composite measures (models/composite.py), the host pool
(utils/processing_pool.py), ``cli.evaluate_covl`` and ``cli.merge_dnsmos`` of
the port against the JAX package's, on the CPU.

Both packages compute these in numpy, so every value is held to 1e-9
relative: WSS, LLR, SSNR, the LPC, ``eval_composite`` (PESQ from each
package's native PESQ) at 16 and 8 kHz, on speech-like wavs, a noisy and a
silent estimate; the output JSONs of ``evaluate_covl`` on one folder of
reference-named pairs (``NNNN.tgtC.wav``, ``NNNN.enhC.wav``); those of
``merge_dnsmos`` on one result folder and DNSMOS CSV, written here, in both
record layouts (``cli.evaluate``'s list, ``cli.evaluate_mp``'s dict). The
port's ``evaluate_covl`` also reads the wavs ``cli.evaluate --save-n``
writes (``NNN_tgtC.wav``, ``NNN_enhC.wav`` and the mixtures, one folder),
giving the values the JAX CLI gives on the same pairs renamed.
"""
import csv
import json
import math

import numpy as np
import pytest

from diffsep_tpu.cli import evaluate_covl as jax_covl
from diffsep_tpu.cli import merge_dnsmos as jax_merge
from diffsep_tpu.models import composite as jax_composite
from diffsep_tpu_torch.cli import evaluate_covl as covl
from diffsep_tpu_torch.cli import merge_dnsmos as merge
from diffsep_tpu_torch.data.audio_io import save_wav
from diffsep_tpu_torch.models import composite
from diffsep_tpu_torch.utils.processing_pool import ProcessingPool

RTOL = 1e-9


def _speech(rng, fs, seconds=1.5):
    t = np.arange(int(fs * seconds)) / fs
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3 * t) ** 2
    x = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 6)) / (k + 1) for k, f in enumerate((180, 360, 740, 1500)))
    return (0.2 * env * x + 0.005 * rng.standard_normal(t.size)).astype(np.float64)


def _close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, tuple) or isinstance(want, list) and any(isinstance(v, (dict, tuple)) for v in want):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    elif isinstance(want, (list, np.ndarray)):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, equal_nan=True)
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == pytest.approx(want, rel=RTOL, abs=0) if isinstance(want, float) else got == want


@pytest.fixture(scope="module", params=[16000, 8000])
def signals(request):
    fs = request.param
    rng = np.random.default_rng(fs)
    ref = _speech(rng, fs)
    return fs, ref, ref + 0.05 * rng.standard_normal(ref.size)


@pytest.mark.parametrize("fn", ["wss", "llr", "ssnr"])
def test_frame_measures_equal_jax(signals, fn):
    fs, ref, deg = signals
    _close(getattr(composite, fn)(ref, deg, fs), getattr(jax_composite, fn)(ref, deg, fs))


def test_lpc_equals_jax(signals):
    fs, ref, _ = signals
    frames = ref[: 240 * 8].reshape(8, 240)
    for got, want in zip(composite.lpcoeff_frames(frames, 16), jax_composite.lpcoeff_frames(frames, 16)):
        _close(got, want)
    for got, want in zip(composite.lpcoeff(frames[3], 10), jax_composite.lpcoeff(frames[3], 10)):
        _close(got, want)


def test_eval_composite_equals_jax(signals):
    fs, ref, deg = signals
    got = composite.eval_composite(ref, deg, fs=fs)
    want = jax_composite.eval_composite(ref, deg, fs=fs)
    assert all(np.isfinite(got[k]) for k in ("csig", "cbak", "covl"))
    _close(got, want)
    _close(composite.eval_composite(ref, deg, fs=fs, pesq_value=2.5),
           jax_composite.eval_composite(ref, deg, fs=fs, pesq_value=2.5))
    assert composite.trim_mos(7.0) == jax_composite.trim_mos(7.0) == 5.0


def test_eval_composite_silent_estimate_equals_jax():
    fs = 16000
    ref = _speech(np.random.default_rng(3), fs)
    got = composite.eval_composite(ref, np.zeros_like(ref), fs=fs)
    _close(got, jax_composite.eval_composite(ref, np.zeros_like(ref), fs=fs))


def test_processing_pool_orders_results_and_keeps_errors():
    def work(i):
        if i == 2:
            raise RuntimeError("boom")
        return i * i

    with ProcessingPool(2) as pool:
        for i in range(5):
            pool.push(work, i)
        assert pool.wait_results() == [0, 1, None, 9, 16]
        assert len(pool.errors) == 1 and "boom" in pool.errors[0]


def _pairs(base, fs=16000, n_samples=2, n_ch=2, saved=False):
    """Clean and enhanced wavs: the reference's names in two folders, or
    the names ``cli.evaluate`` saves (with the mixtures) in one."""
    rng = np.random.default_rng(31)
    enh = base / "results" / "tag" / "wav" / "test"
    clean = enh if saved else base / "clean"
    for i in range(n_samples):
        if saved:
            save_wav(enh / f"{i:03d}_mix.wav", np.full((1, fs), 0.1, np.float32), fs)
        for c in range(n_ch):
            x = _speech(rng, fs, 1.0)
            y = x + 0.05 * rng.standard_normal(x.size)
            if saved:
                save_wav(enh / f"{i:03d}_tgt{c}.wav", x[None].astype(np.float32), fs)
                save_wav(enh / f"{i:03d}_enh{c}.wav", y[None].astype(np.float32), fs)
            else:
                save_wav(clean / f"{i:04d}.tgt{c}.wav", x[None].astype(np.float32), fs)
                save_wav(enh / f"{i:04d}.enh{c}.wav", y[None].astype(np.float32), fs)
    return clean, enh


def _outputs(enh):
    out = enh.parents[1]
    return [json.loads((out / name).read_text()) for name in ("test_covl.json", "test_summary_covl.json")]


def test_evaluate_covl_equals_the_jax_cli(tmp_path):
    ours = _pairs(tmp_path / "ours")
    theirs = _pairs(tmp_path / "theirs")
    covl.main([str(p) for p in ours])
    jax_covl.main([str(p) for p in theirs])
    got, want = _outputs(ours[1]), _outputs(theirs[1])
    assert sorted(got[0]) == ["0", "1"] and all(len(v["csig"]) == 2 for v in got[0].values())
    assert all(np.isfinite(v).all() for e in got[0].values() for v in e.values())
    _close(got, want)


def test_evaluate_covl_reads_what_cli_evaluate_saves(tmp_path):
    clean, enh = _pairs(tmp_path / "saved", saved=True)
    covl.main([str(clean), str(enh)])
    theirs = _pairs(tmp_path / "theirs")  # the same draws, renamed
    jax_covl.main([str(p) for p in theirs])
    _close(_outputs(enh), _outputs(theirs[1]))
    assert covl.filename_tgt2enh(enh / "000_mix.wav", enh) is None


FIELDNAMES = ["", "filename", "len_in_sec", "sr", "num_hops", "OVRL_raw", "SIG_raw", "BAK_raw", "OVRL", "SIG", "BAK"]


def _results_dir(base, layout):
    base.mkdir(parents=True)
    records = []
    for idx in range(3):
        si = [[6.0 + idx, float("inf") if idx == 1 else 5.5 + idx]]
        records.append({"batch_idx": idx, "si_sdr": si, "pesq": [3.0 + 0.1 * idx, 2.9 + 0.1 * idx], "nfe": 60,
                        "runtime": 1.5, "len_s": 5.0})
    results = records if layout == "list" else {str(r["batch_idx"]): r for r in records}
    (base / "test.json").write_text(json.dumps(results))
    with open(base / "test_dnsmos.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(FIELDNAMES)
        for row, (idx, ch) in enumerate((i, c) for i in range(3) for c in range(2)):
            w.writerow([row, f"wav/test/{idx:04d}.enh{ch}.wav", 5.0, 8000, 56, 2.0 + 0.1 * idx + 0.01 * ch,
                        2.5 + 0.1 * idx, 2.2 + 0.05 * ch, 2.1 + 0.1 * idx, 2.6 + 0.1 * idx, 2.3 + 0.05 * ch])
    return base


@pytest.mark.parametrize("layout", ["list", "dict"])
@pytest.mark.parametrize("overwrite", [False, True])
def test_merge_dnsmos_equals_the_jax_cli(tmp_path, layout, overwrite):
    ours, theirs = _results_dir(tmp_path / "ours", layout), _results_dir(tmp_path / "theirs", layout)
    flag = ["--overwrite-results"] if overwrite else []
    merge.main([str(ours), *flag])
    jax_merge.main([str(theirs), *flag])
    names = ["test.json", "test_summary.json"] if overwrite else ["test_with_dnsmos.json",
                                                                  "test_summary_with_dnsmos.json"]
    for name in names:
        got, want = (json.loads((d / name).read_text()) for d in (ours, theirs))
        _close(got, want)
    merged = json.loads((ours / names[0]).read_text())
    first = merged[0] if layout == "list" else merged["0"]
    assert first["OVRL"] == [2.1, 2.1] and first["sr"] == [8000, 8000]


def test_merge_dnsmos_checks_the_header(tmp_path):
    d = _results_dir(tmp_path / "bad", "list")
    text = (d / "test_dnsmos.csv").read_text().replace("OVRL_raw", "OVRL_rw", 1)
    (d / "test_dnsmos.csv").write_text(text)
    with pytest.raises(ValueError, match="error in the DNSMOS file"):
        merge.main([str(d)])
