"""The port's C++ WAV decoder (data/native_io.py over csrc/wavio.cpp)
against scipy and the JAX package's binding, on the CPU: decoded samples
equal bit for bit (integer PCM scaled by a power of two; float32 copied),
16-bit writes read back as the writer truncates them, and WSJ0_mix.getitem_batch
equals item-by-item decoding, crops included."""
from __future__ import annotations

import logging

import numpy as np
import pytest
from scipy.io import wavfile

from diffsep_tpu.data import native_io as jax_native_io
from diffsep_tpu_torch.data import audio_io, native_io
from diffsep_tpu_torch.data.loader import DataLoader
from diffsep_tpu_torch.data.synthetic import write_wsj0_mix
from diffsep_tpu_torch.data.wsj0_mix import WSJ0_mix


def _signal(shape, seed):
    return np.clip(np.random.default_rng(seed).standard_normal(shape) * 0.3, -0.99, 0.99)


# (dtype scipy writes, channels)
FORMATS = [("int16", 1), ("int16", 2), ("int32", 2), ("float32", 3)]


def _write(path, dtype, channels, seed, fs=16000):
    x = _signal((1000 + 7 * seed, channels), seed)
    if dtype == "int16":
        data = (x * 32767).astype(np.int16)
    elif dtype == "int32":
        data = (x * 2**31).astype(np.int32)
    else:
        data = x.astype(np.float32)
    wavfile.write(str(path), fs, data[:, 0] if channels == 1 else data)


def test_build_is_keyed_by_source_and_flags():
    path = native_io.build()
    assert path.exists() and path.parent == native_io.BUILD_DIR
    assert path.name.startswith("wavio-") and native_io.build() == path
    assert native_io.available()


@pytest.mark.parametrize("dtype,channels", FORMATS)
def test_load_equals_scipy_and_the_jax_binding(tmp_path, monkeypatch, dtype, channels):
    path = tmp_path / "a.wav"
    _write(path, dtype, channels, seed=channels)
    want, fs = audio_io.load_wav(path)
    got, fs_n = native_io.load_wav(path)
    assert fs == fs_n == 16000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # the JAX package's binding over the same C ABI (its library is the
    # port's build of the same source)
    monkeypatch.setattr(jax_native_io, "_LIB", None)
    monkeypatch.setattr(jax_native_io, "_find_lib", native_io.build)
    np.testing.assert_array_equal(jax_native_io.load_wav(path)[0], got)


def test_batch_equals_per_file(tmp_path):
    paths, want = [], []
    for i, (dtype, channels) in enumerate(FORMATS):
        p = tmp_path / f"f{i}.wav"
        _write(p, dtype, channels, seed=i)
        paths.append(p)
        want.append(audio_io.load_wav(p)[0])
    before = native_io.batch_calls
    got = native_io.load_wav_batch(paths * 3, n_threads=3)
    assert native_io.batch_calls == before + 1
    for g, w in zip(got, want * 3):
        np.testing.assert_array_equal(g, w)


def test_errors(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav file at all" * 4)
    with pytest.raises(IOError):
        native_io.load_wav(bad)
    with pytest.raises(IOError):
        native_io.load_wav_batch([bad])
    with pytest.raises(IOError):
        native_io.save_wav(tmp_path / "missing" / "x.wav", np.zeros(4), 8000)


def test_write_round_trip(tmp_path):
    x = _signal((2, 512), 5).astype(np.float32)
    native_io.save_wav(tmp_path / "w.wav", x, 8000)
    y, fs = audio_io.load_wav(tmp_path / "w.wav")
    assert fs == 8000 and y.shape == x.shape
    # 16-bit PCM as the C++ writer rounds it: v * 32767 truncated
    np.testing.assert_array_equal(y, (x * np.float32(32767)).astype(np.int16).astype(np.float32) / 32768)
    native_io.save_wav(tmp_path / "m.wav", x[0], 8000)
    assert audio_io.load_wav(tmp_path / "m.wav")[0].shape == (1, 512)


def test_backend_switch(tmp_path):
    _write(tmp_path / "b.wav", "int16", 2, seed=7)
    want = audio_io.load_wav(tmp_path / "b.wav")
    try:
        audio_io.set_backend("native")
        got = audio_io.load_wav(tmp_path / "b.wav")
    finally:
        audio_io.set_backend("scipy")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    with pytest.raises(ValueError):
        audio_io.set_backend("torchaudio")


@pytest.mark.parametrize("max_len_s", [None, 0.3])
def test_getitem_batch_equals_per_item(tmp_path, max_len_s):
    write_wsj0_mix(tmp_path, {"train": 5}, seconds=0.5, seed=3)
    kw = dict(fs=8000, split="train", max_len_s=max_len_s)
    a = WSJ0_mix(tmp_path, rng=np.random.default_rng(1), **kw)
    b = WSJ0_mix(tmp_path, rng=np.random.default_rng(1), **kw)
    before = native_io.batch_calls
    rows = a.getitem_batch([3, 0, 4])
    assert native_io.batch_calls == before + 1
    for (mix, tgt), i in zip(rows, [3, 0, 4]):
        want_mix, want_tgt = b[i]
        np.testing.assert_array_equal(mix, want_mix)
        np.testing.assert_array_equal(tgt, want_tgt)


def test_loader_takes_the_batch_call(tmp_path):
    write_wsj0_mix(tmp_path, {"train": 6}, seconds=0.25, seed=4)
    ds = WSJ0_mix(tmp_path, fs=8000, split="train")
    before = native_io.batch_calls
    batches = list(DataLoader(ds, batch_size=3, num_shards=1))
    assert native_io.batch_calls == before + 2 and batches[0][1].shape[:2] == (3, 2)


def test_fallback_where_the_decoder_cannot_be_built(tmp_path, monkeypatch, caplog):
    write_wsj0_mix(tmp_path, {"train": 2}, seconds=0.25, seed=5)
    ds = WSJ0_mix(tmp_path, fs=8000, split="train")
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_warned", False)
    monkeypatch.setattr(native_io, "_compiler", lambda: "/nonexistent/c++")
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "build")
    before = native_io.batch_calls
    with caplog.at_level(logging.WARNING):
        rows = ds.getitem_batch([1, 0])
        ds.getitem_batch([0])
    assert native_io.batch_calls == before
    assert sum("unavailable" in r.message for r in caplog.records) == 1
    np.testing.assert_array_equal(rows[0][0], ds[1][0])


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "wavio.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native_io, "SOURCE", src)
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        native_io.build()
    assert not list((tmp_path / "build").glob("*"))
