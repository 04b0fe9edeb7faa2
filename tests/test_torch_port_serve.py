"""The port's serving entry point (diffsep_tpu_torch/cli/serve.py and
cli/serve_http.py) on the CPU with a tiny model that
diffsep_tpu_torch.cli.train trained for two steps: the cases of
tests/test_serve.py (the export artifact's are in test_torch_port_export.py), and a
parity case: the port's and the JAX package's engine front halves
(bucketing, normalization, padding rows, scale_output, slicing), each with
its sampler replaced by the same deterministic stand-in, give the same
estimates to 1e-6 and the same 16-bit wavs to one step."""
import argparse
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import one_torch_thread  # noqa: F401
from diffsep_tpu_torch.cli import serve as serve_mod
from diffsep_tpu_torch.cli.loading import load_model
from diffsep_tpu_torch.cli.serve import SeparationEngine, _EngineBase, _stdin_loop, _watch_loop
from diffsep_tpu_torch.cli.serve_http import HTTPSeparationServer
from diffsep_tpu_torch.data.audio_io import load_wav, load_wav_bytes, save_wav, wav_to_bytes
from diffsep_tpu_torch.data.synthetic import write_wsj0_mix
from diffsep_tpu_torch.train.checkpoints import load_payload
from diffsep_tpu_torch.train.losses import normalize_batch, normalize_rows_host

TINY_TRAIN = [
    "trainer.accelerator=cpu", "model.score_model.backbone_args.nf=8",
    "model.score_model.backbone_args.ch_mult=[1,2,2]", "model.score_model.backbone_args.num_res_blocks=1",
    "model.score_model.backbone_args.attn_resolutions=[]", "model.score_model.backbone_args.dtype=float32",
    "model.score_model.stft_args.n_fft=126", "model.score_model.stft_args.hop_length=32",
    "model.sampler.N=2", "model.valid_max_sep_batches=1", "datamodule.train.dl_opts.batch_size=2",
    "datamodule.val.dl_opts.batch_size=2", "trainer.max_steps=2", "trainer.accumulate_grad_batches=1",
]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A port run dir: two training steps of the tiny model through the
    training entry point."""
    from diffsep_tpu_torch.cli import train as train_cli

    data = write_wsj0_mix(tmp_path_factory.mktemp("wsj0_mix"), {"train": 2, "val": 2}, seconds=0.5, seed=0)
    exp = tmp_path_factory.mktemp("exp")
    train_cli.main(["experiment=icassp-separation", f"path.datasets.wsj0_mix={data}", f"path.exp_root={exp}",
                    *TINY_TRAIN])
    (run,) = [p for p in (exp / "default").iterdir() if p.is_dir()]
    return run


@pytest.fixture(scope="module")
def model(run_dir):
    return load_model(run_dir, device="cpu")


def _wav(path, n, seed, channels=1, fs=8000):
    save_wav(path, np.random.default_rng(seed).standard_normal((channels, n)).astype(np.float32) * 0.1, fs)
    return path


def test_the_run_dir_serves_its_ema_weights(run_dir, model):
    ema = load_payload(run_dir / "checkpoints" / "latest.pt")["train_state"]["ema"]["params"]
    raw = load_payload(run_dir / "checkpoints" / "latest.pt")["model"]
    got = model.score_model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in ema.items())
    assert any(not torch.equal(ema[k], raw[k]) for k in raw)


def test_engine_micro_batches_and_buckets(model, tmp_path):
    eng = SeparationEngine(model, batch=2, bucket_s=0.3, sampler_kwargs={"N": 2})
    lengths = [2000, 2100, 4000]  # two buckets
    paths = [_wav(tmp_path / f"in{i}.wav", n, i) for i, n in enumerate(lengths)]
    out = tmp_path / "out"
    results = list(eng.process(paths, out))
    assert len(results) == 3 and all(ok for _, ok, _ in results)
    assert eng.n_req == 2  # one sampler run per micro-batch
    for p, n in zip(paths, lengths):
        for s in ("s0", "s1"):
            wav, sr = load_wav(out / s / f"{p.stem}.wav")
            assert sr == 8000 and wav.shape == (1, n) and np.isfinite(wav).all()


def test_engine_skips_bad_inputs(model, tmp_path):
    eng = SeparationEngine(model, batch=1, sampler_kwargs={"N": 2})
    bad_sr = _wav(tmp_path / "bad_sr.wav", 1000, 0, fs=16000)
    results = list(eng.process([bad_sr, tmp_path / "missing.wav"], tmp_path / "o"))
    assert [ok for _, ok, _ in results] == [False, False]
    assert "sample rate" in results[0][2]
    assert eng.validate(np.zeros((1, 0), np.float32), 8000) == "empty signal"


def test_engine_normalizes_on_true_length():
    rng = np.random.default_rng(3)
    wav = rng.standard_normal((1, 1600)).astype(np.float32) * 0.1 + 0.03
    rows, means, stds = normalize_rows_host([wav], padded=8000)
    (_, _), mean_ref, std_ref = normalize_batch(torch.from_numpy(wav)[None])
    assert np.isclose(means[0], mean_ref.item(), atol=1e-6)
    assert np.isclose(stds[0], std_ref.item(), atol=1e-6)
    rows2, _, stds2 = normalize_rows_host([wav], padded=1600)
    assert np.isclose(stds[0], stds2[0])
    assert rows[0].shape == (1, 8000)
    assert np.allclose(rows[0][:, :1600], rows2[0])
    assert np.all(rows[0][:, 1600:] == 0)


def test_engine_pipelines_depth1_and_isolates_finalize_errors(tmp_path):
    events = []

    class _PipelineProbe(_EngineBase):
        fs, batch, bucket = 8000, 1, 800

        def _dispatch_bucket(self, mixes):
            events.append("dispatch")
            return events.count("dispatch"), mixes

        def _finalize_bucket(self, handle):
            k, mixes = handle
            events.append("finalize")
            if k == 2:
                raise RuntimeError("device fault")
            return [np.zeros((2, m.shape[-1]), np.float32) for m in mixes]

    paths = [_wav(tmp_path / f"u{i}.wav", 790, i) for i in range(3)]
    out = tmp_path / "out"
    results = {p: (ok, msg) for p, ok, msg in _PipelineProbe().process(paths, out)}
    assert events == ["dispatch", "dispatch", "finalize", "dispatch", "finalize", "finalize"]
    assert results[paths[0]][0] and results[paths[2]][0]
    assert not results[paths[1]][0] and "device fault" in results[paths[1]][1]
    assert (out / "s0" / "u0.wav").exists() and (out / "s0" / "u2.wav").exists()
    assert not (out / "s0" / "u1.wav").exists()


def test_dispatch_leaves_the_estimate_on_the_device(model):
    """_dispatch_bucket hands back the sampler's tensor; the copy to the
    host is _finalize_bucket's."""
    eng = SeparationEngine(model, batch=2, sampler_kwargs={"N": 2})
    handle = eng._dispatch_bucket([np.full((1, 900), 0.1, np.float32) + np.arange(900, dtype=np.float32) * 1e-4])
    assert isinstance(handle[0], torch.Tensor) and handle[0].shape == (2, 2, 8000)
    (est,) = eng._finalize_bucket(handle)
    assert isinstance(est, np.ndarray) and est.shape == (2, 900)


def test_engine_is_deterministic_per_seed(model):
    mixes = [np.random.default_rng(i).standard_normal((1, 1200)).astype(np.float32) * 0.1 for i in range(2)]
    a = SeparationEngine(model, batch=2, seed=5, sampler_kwargs={"N": 2})._run_bucket(mixes)
    b = SeparationEngine(model, batch=2, seed=5, sampler_kwargs={"N": 2})._run_bucket(mixes)
    c = SeparationEngine(model, batch=2, seed=6, sampler_kwargs={"N": 2})._run_bucket(mixes)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.allclose(a[0], c[0])


def test_engine_write_errors_do_not_kill_serving(model, tmp_path):
    eng = SeparationEngine(model, batch=1, sampler_kwargs={"N": 2})
    p = _wav(tmp_path / "x.wav", 1600, 0)
    blocker = tmp_path / "outfile"
    blocker.write_text("")
    results = list(eng.process([p], blocker))
    assert len(results) == 1 and results[0][1] is False and "write failed" in results[0][2]


def test_engine_rejects_stereo_inputs(model, tmp_path):
    eng = SeparationEngine(model, batch=2, sampler_kwargs={"N": 2})
    stereo = _wav(tmp_path / "stereo.wav", 1600, 4, channels=2)
    mono = _wav(tmp_path / "mono.wav", 1600, 5)
    results = {p.name: (ok, msg) for p, ok, msg in eng.process([stereo, mono], tmp_path / "o")}
    assert results["stereo.wav"][0] is False and "mono" in results["stereo.wav"][1]
    assert results["mono.wav"][0] is True


def _fake_sleep(monkeypatch, on_poll):
    polls = {"n": 0}

    def sleep(_):
        polls["n"] += 1
        if on_poll(polls["n"]):
            raise KeyboardInterrupt

    monkeypatch.setattr(serve_mod.time, "sleep", sleep)


def test_watch_retries_failed_files(model, tmp_path, capsys, monkeypatch):
    eng = SeparationEngine(model, batch=1, sampler_kwargs={"N": 2})
    watch = tmp_path / "inbox"
    watch.mkdir()
    (watch / "bad.wav").write_bytes(b"not a wav file")
    args = argparse.Namespace(watch=watch, output_dir=tmp_path / "out", poll_s=0.01, once=False, batch=1)
    _fake_sleep(monkeypatch, lambda n: n >= serve_mod.MAX_ATTEMPTS + 2)
    with pytest.raises(KeyboardInterrupt):
        _watch_loop(eng, args)
    errors = [line for line in capsys.readouterr().out.splitlines() if line.startswith("ERROR")]
    assert len(errors) == serve_mod.MAX_ATTEMPTS and "giving up" in errors[-1]


def test_watch_once_mode(run_dir, tmp_path):
    watch = tmp_path / "inbox"
    watch.mkdir()
    _wav(watch / "a.wav", 1600, 2)
    out = tmp_path / "served"
    serve_mod.main([str(out), "--model", str(run_dir), "--watch", str(watch), "--once", "--batch", "1",
                    "-N", "2", "--device", "cpu", "--corrector", "langevin", "--snr", "0.2"])
    for s in ("s0", "s1"):
        wav, sr = load_wav(out / s / "a.wav")
        assert sr == 8000 and wav.shape == (1, 1600) and np.isfinite(wav).all()


def test_serve_needs_cuda_unless_cpu_is_asked(run_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_mod.main([str(tmp_path / "o"), "--model", str(run_dir), "--watch", str(tmp_path), "--once"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        serve_mod.main([str(tmp_path / "o"), "--http", ":0", "--watch", str(tmp_path)])


class _FakeEngine:
    def __init__(self):
        self.calls = []

    def process(self, paths, output_dir):
        self.calls.append([str(p) for p in paths])
        for p in paths:
            yield p, True, "ok"


def test_stdin_loop_drains_pending_lines_into_one_batch(tmp_path, capsys, monkeypatch):
    r, w = os.pipe()
    with os.fdopen(w, "w") as wf:
        wf.write("a.wav\nb.wav\n\nc.wav")  # a blank line, and no newline at the end
    eng = _FakeEngine()
    rf = os.fdopen(r, "r")
    monkeypatch.setattr(sys, "stdin", rf)
    try:
        _stdin_loop(eng, argparse.Namespace(batch=4, output_dir=tmp_path))
    finally:
        rf.close()
    assert eng.calls == [["a.wav", "b.wav", "c.wav"]]
    assert len([line for line in capsys.readouterr().out.splitlines() if line.startswith("DONE")]) == 3


def test_stdin_loop_drains_single_write_while_pipe_open(tmp_path, monkeypatch):
    r, w = os.pipe()
    wf = os.fdopen(w, "w")
    wf.write("a.wav\nb.wav\nc.wav\n")
    wf.flush()
    eng = _FakeEngine()
    rf = os.fdopen(r, "r")
    monkeypatch.setattr(sys, "stdin", rf)

    def close_when_processed():
        deadline = time.time() + 10
        while not eng.calls and time.time() < deadline:
            time.sleep(0.01)
        wf.close()

    t = threading.Thread(target=close_when_processed)
    t.start()
    try:
        _stdin_loop(eng, argparse.Namespace(batch=4, output_dir=tmp_path))
    finally:
        t.join()
        rf.close()
    assert eng.calls == [["a.wav", "b.wav", "c.wav"]]


def test_stdin_loop_caps_batches(tmp_path, monkeypatch):
    r, w = os.pipe()
    with os.fdopen(w, "w") as wf:
        wf.write("".join(f"{i}.wav\n" for i in range(5)))
    eng = _FakeEngine()
    rf = os.fdopen(r, "r")
    monkeypatch.setattr(sys, "stdin", rf)
    try:
        _stdin_loop(eng, argparse.Namespace(batch=2, output_dir=tmp_path))
    finally:
        rf.close()
    assert eng.calls == [["0.wav", "1.wav"], ["2.wav", "3.wav"], ["4.wav"]]


def test_watch_picks_up_redropped_file(tmp_path, monkeypatch):
    watch = tmp_path / "inbox"
    watch.mkdir()
    f = watch / "a.wav"
    f.write_bytes(b"x" * 100)
    eng = _FakeEngine()
    args = argparse.Namespace(watch=watch, output_dir=tmp_path / "out", poll_s=0.0, once=False, batch=1)

    def on_poll(n):
        if n == 3:
            f.unlink()
        if n == 4:
            f.write_bytes(b"y" * 120)
        return n >= 8

    _fake_sleep(monkeypatch, on_poll)
    with pytest.raises(KeyboardInterrupt):
        _watch_loop(eng, args)
    assert [c for c in eng.calls if c] == [[str(f)], [str(f)]]


def test_watch_skips_growing_files_until_stable(tmp_path, monkeypatch):
    watch = tmp_path / "inbox"
    watch.mkdir()
    f = watch / "grow.wav"
    f.write_bytes(b"x" * 100)
    eng = _FakeEngine()
    args = argparse.Namespace(watch=watch, output_dir=tmp_path / "out", poll_s=0.0, once=False, batch=1)

    def on_poll(n):
        if n == 1:
            f.write_bytes(b"x" * 200)
        return n >= 4

    _fake_sleep(monkeypatch, on_poll)
    with pytest.raises(KeyboardInterrupt):
        _watch_loop(eng, args)
    assert [c for c in eng.calls if c] == [[str(f)]]


def test_streaming_real_model_long_file(run_dir, model, tmp_path):
    from diffsep_tpu_torch.cli.separate import main as separate_main
    from diffsep_tpu_torch.streaming import separate_streaming

    n = 3 * 8000
    mix = (np.random.default_rng(7).standard_normal((1, n)) * 0.1).astype(np.float32)
    out = separate_streaming(model, mix, chunk_s=1.0, overlap_s=0.25, batch=2, N=2,
                             generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, n) and np.isfinite(out).all()
    indir = tmp_path / "in"
    indir.mkdir()
    save_wav(indir / "long.wav", mix, 8000)
    separate_main([str(indir), str(tmp_path / "out"), "--model", str(run_dir), "--stream-chunk-s", "1.0",
                   "--stream-overlap-s", "0.25", "-N", "2", "--device", "cpu"])
    for s in ("s0", "s1"):
        wav, sr = load_wav(tmp_path / "out" / s / "long.wav")
        assert sr == 8000 and wav.shape == (1, n) and np.isfinite(wav).all()


def _http(method, url, body=None):
    req = urllib.request.Request(url, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_http_separate_roundtrip_and_endpoints(model):
    eng = SeparationEngine(model, batch=2, sampler_kwargs={"N": 2})
    wav = np.random.default_rng(11).standard_normal((1, 1600)).astype(np.float32) * 0.1
    with HTTPSeparationServer(eng, port=0) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        code, headers, body = _http("POST", base + "/v1/separate", wav_to_bytes(wav, 8000))
        assert code == 200, body
        assert headers["X-Diffsep-Sources"] == "2" and float(headers["X-Diffsep-Latency-Ms"]) > 0
        est, sr = load_wav_bytes(body)
        assert sr == 8000 and est.shape == (2, 1600) and np.isfinite(est).all()
        code, _, body = _http("GET", base + "/healthz")
        health = json.loads(body)
        assert code == 200 and health["status"] == "ok" and health["fs"] == 8000 and health["batch"] == 2
        code, _, body = _http("GET", base + "/metrics")
        text = body.decode()
        assert code == 200
        assert 'diffsep_requests_total{status="ok"} 1' in text
        assert "diffsep_batch_fill_count 1" in text


def test_http_rejects_bad_requests(model):
    eng = SeparationEngine(model, batch=1, sampler_kwargs={"N": 2})
    with HTTPSeparationServer(eng, port=0) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        code, _, body = _http("POST", base + "/v1/separate", wav_to_bytes(np.zeros((1, 800), np.float32), 16000))
        assert code == 400 and "sample rate" in json.loads(body)["error"]
        code, _, body = _http("POST", base + "/v1/separate", wav_to_bytes(np.zeros((2, 800), np.float32), 8000))
        assert code == 400 and "mono" in json.loads(body)["error"]
        code, _, body = _http("POST", base + "/v1/separate", b"not a wav")
        assert code == 400 and "decode" in json.loads(body)["error"]
        code, _, _ = _http("POST", base + "/nope", b"x")
        assert code == 404
        code, _, body = _http("GET", base + "/metrics")
        assert 'diffsep_requests_total{status="error"} 4' in body.decode()
        assert "diffsep_batch_fill_count 0" in body.decode()  # nothing reached the model


class _StubEngine(_EngineBase):
    """The engine's base class with a sampler stand-in: records the size
    of each micro-batch it dispatches, returns zeros."""

    def __init__(self, fs=8000, batch=4, bucket=800):
        self.fs, self.batch, self.bucket = fs, batch, bucket
        self.calls = []

    def _dispatch_bucket(self, mixes):
        self.calls.append(len(mixes))
        return mixes

    def _finalize_bucket(self, mixes):
        return [np.zeros((2, m.shape[-1]), np.float32) for m in mixes]


def test_http_concurrent_requests_share_a_micro_batch():
    eng = _StubEngine(batch=4)
    srv = HTTPSeparationServer(eng, port=0)  # the worker is not started yet
    try:
        pend = [srv.submit(np.zeros((1, 700), np.float32)) for _ in range(3)]
        srv._worker.start()
        for p in pend:
            assert p.done.wait(30)
            assert p.est is not None and p.est.shape == (2, 700)
        assert eng.calls == [3]
        assert srv.metrics.batch_fill_sum == 3 and srv.metrics.batch_runs == 1
    finally:
        srv.shutdown()


def test_http_full_queue_answers_503_and_a_slow_request_504():
    eng = _StubEngine(batch=1)
    srv = HTTPSeparationServer(eng, port=0, max_queue=1, timeout_s=0.3)
    srv._listening = True
    serve = threading.Thread(target=srv._httpd.serve_forever, daemon=True)
    serve.start()  # the listener runs, the batcher does not
    try:
        base = f"http://127.0.0.1:{srv.port}/v1/separate"
        body = wav_to_bytes(np.zeros((1, 400), np.float32), 8000)
        first = {}
        t = threading.Thread(target=lambda: first.update(r=_http("POST", base, body)))
        t.start()
        deadline = time.time() + 10
        while srv._queue.qsize() < 1 and time.time() < deadline:
            time.sleep(0.01)
        code, _, msg = _http("POST", base, body)
        assert code == 503 and "saturated" in json.loads(msg)["error"]
        t.join()
        assert first["r"][0] == 504
        assert srv._httpd.request_queue_size >= 128  # the listen backlog takes a burst
    finally:
        srv.shutdown()


class _JaxStandIn:
    """The JAX model's get_pc_sampler contract with a deterministic
    stand-in for the sampler."""

    class config:
        class model:
            fs = 8000

    def get_pc_sampler(self, predictor, corrector, y, params, key=None, **kw):
        return lambda: (jnp.concatenate([jnp.tanh(2 * y) + 0.05, 0.5 * y - 0.2 * y ** 2], axis=1), 1)


class _PortStandIn:
    config = {"fs": 8000}
    device = torch.device("cpu")

    def get_pc_sampler(self, predictor, corrector, y, generator=None, **kw):
        return lambda: (torch.cat([torch.tanh(2 * y) + 0.05, 0.5 * y - 0.2 * y ** 2], dim=1), 1)


def test_engine_front_half_matches_the_jax_package(tmp_path):
    from diffsep_tpu.cli.serve import SeparationEngine as JaxEngine

    lengths = [1234, 800, 2500, 2400, 1, 4001]
    paths = [_wav(tmp_path / f"r{i}.wav", n, 30 + i) for i, n in enumerate(lengths)]
    port = SeparationEngine(_PortStandIn(), batch=3, bucket_s=0.3)
    ref = JaxEngine(_JaxStandIn(), None, batch=3, bucket_s=0.3)
    mixes = [load_wav(p)[0] for p in paths]
    for chunk in port.chunks(mixes, lambda m: m.shape[-1]):
        for got, want in zip(port._run_bucket(chunk), ref._run_bucket(chunk)):
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-6)
    for name, eng in (("port", port), ("jax", ref)):
        assert all(ok for _, ok, _ in eng.process(paths, tmp_path / name))
    for p in paths:
        for s in ("s0", "s1"):
            a, _ = load_wav(tmp_path / "port" / s / p.name)
            b, _ = load_wav(tmp_path / "jax" / s / p.name)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1.0 / 32768 + 1e-9
