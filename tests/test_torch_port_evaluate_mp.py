"""Multi-device evaluation in the port (cli/evaluate_mp.py,
parallel/shard_eval.py, the threaded launch counters) against the JAX
package's (diffsep_tpu/cli/evaluate_mp.py, parallel/shard_eval.py) on the
CPU.

* ``make_tasks`` and ``pad_batch_to_devices``: the JAX functions' output,
  exactly.
* ``make_sharded_separate`` over two CPU "devices" (one model copy and one
  thread each) against one ``separate`` call on the real rows, with the same
  noise: within 1e-5 of the estimates' scale (the same float32 ops on
  smaller batches).
* The launch counters under 8 threads with a 1 us switch interval: exact.
* ``cli.evaluate_mp`` against the JAX CLI on the same reference-layout
  checkpoint of the tiny float32 model and the same folder (test files of
  1.3, 1.3 and 0.6 s), two workers, the port handed the JAX sampler's draws
  for each utterance or batch (``fold_in(PRNGKey(seed), index)`` of the
  batch's first utterance, at the padded shape): per utterance, and with
  ``--batch-size 2`` (1 s buckets, the batch padded with zero rows). The
  dir name and the summary's keys equal; the records (a dict keyed by
  index) within SI-SDR/SIR/SAR 0.01 dB, STOI 1e-3, PESQ 0.01 (the
  tolerances of test_torch_port_evaluate_cli.py), the other keys exactly,
  runtime aside. ``__no_proc__``: identical files.
* A run whose config pins a sampler (a distilled stage's) is evaluated at
  it without flags (the port's own default, as in cli/evaluate.py).
"""
import json
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_port_util import (JAX_TINY_OVERRIDES, PORT_TINY_CONFIG, jax_pc_noise, one_torch_thread,  # noqa: F401
                              random_params)
from diffsep_tpu.cli.evaluate_mp import main as jax_evaluate_mp_main
from diffsep_tpu.cli.evaluate_mp import make_tasks as jax_make_tasks
from diffsep_tpu.config import compose
from diffsep_tpu.config.compose import to_dict
from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel
from diffsep_tpu.models.convert import save_reference_checkpoint
from diffsep_tpu.parallel.shard_eval import pad_batch_to_devices as jax_pad_batch_to_devices
from diffsep_tpu_torch.cli import evaluate_mp as cli
from diffsep_tpu_torch.data.audio_io import load_wav, save_wav
from diffsep_tpu_torch.data.synthetic import write_wsj0_mix
from diffsep_tpu_torch.model import DiffSepModel
from diffsep_tpu_torch.ops import _build
from diffsep_tpu_torch.parallel.shard_eval import make_sharded_separate, pad_batch_to_devices
from diffsep_tpu_torch.sampling import pc as pc_mod

RECORD_KEYS = {"batch_idx", "si_sdr", "si_sir", "si_sar", "pesq", "stoi", "nfe", "runtime", "len_s"}
TOL = {"si_sdr": 0.01, "si_sir": 0.01, "si_sar": 0.01, "stoi": 1e-3, "pesq": 0.01}


@pytest.mark.parametrize("n_items,n_workers", [(10, 3), (3, 4), (0, 2), (8, 8), (7, 2)])
def test_make_tasks_matches_jax(n_items, n_workers):
    assert cli.make_tasks(n_items, n_workers) == jax_make_tasks(n_items, n_workers)


@pytest.mark.parametrize("b,n_devices", [(3, 2), (4, 2), (5, 4), (1, 3)])
def test_pad_batch_to_devices_matches_jax(b, n_devices):
    batch = np.random.default_rng(b).standard_normal((b, 1, 16)).astype(np.float32)
    got, real = pad_batch_to_devices(batch, n_devices)
    want, want_real = jax_pad_batch_to_devices(batch, n_devices)
    assert real == want_real == b and np.array_equal(got, np.asarray(want))


def test_launch_counts_exact_under_threads():
    """count_launch from many threads at once loses no update."""
    interval = sys.getswitchinterval()
    _build.reset_counts()
    n_threads, n_calls = 8, 4000

    def work():
        for _ in range(n_calls):
            _build.count_launch("conv3x3", (1, 2, 3, 4), 8, backward=True)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    total = n_threads * n_calls
    assert _build.launch_counts["conv3x3"] == _build.backward_counts["conv3x3"] == total
    assert _build.launch_shapes[("conv3x3", (1, 2, 3, 4), 8)] == total
    _build.reset_counts()


def test_sharded_separate_over_two_cpu_devices_matches_one_call():
    model = DiffSepModel(PORT_TINY_CONFIG, device="cpu", seed=3)
    rng = np.random.default_rng(5)
    b, n, N = 3, 1600, 2
    mix = (0.3 * rng.standard_normal((b, 1, n))).astype(np.float32)
    padded = b + 1
    noise = {"prior": torch.from_numpy(rng.standard_normal((padded, 2, n)).astype(np.float32)),
             "corrector": torch.from_numpy(rng.standard_normal((N, 1, padded, 2, n)).astype(np.float32)),
             "predictor": torch.from_numpy(rng.standard_normal((N, padded, 2, n)).astype(np.float32))}
    run = make_sharded_separate(model, ["cpu", "cpu"], N=N)
    got, nfe = run(mix, noise=noise)
    real = {"prior": noise["prior"][:b], "corrector": noise["corrector"][:, :, :b],
            "predictor": noise["predictor"][:, :b]}
    want, want_nfe = model.separate(mix, noise=real, N=N)
    assert got.shape == (b, 2, n) and nfe == want_nfe == 2 * N
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# --------------------------------------------------------------------------
# the CLI against the JAX CLI
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A reference checkpoint of the tiny model whose config names a WSJ0-mix
    folder with test files of 1.3, 1.3 and 0.6 s."""
    tmp = tmp_path_factory.mktemp("eval_mp")
    wsj = write_wsj0_mix(tmp / "wsj0_mix", {"test": 3}, seconds=1.3, seed=4)
    for sub in ("mix", "s1", "s2"):  # the last file cut to 0.6 s: another bucket
        path = wsj / "2speakers" / "wav8k" / "max" / "tt" / sub / "test0002.wav"
        wav, fs = load_wav(path)
        save_wav(path, wav[:, :int(0.6 * fs)], fs)
    cfg = compose([*JAX_TINY_OVERRIDES, f"path.datasets.wsj0_mix={wsj}"])
    params = random_params(JaxDiffSepModel(cfg).score_model, np.random.default_rng(42))
    path = tmp / "sep" / "checkpoints" / "last.ckpt"
    path.parent.mkdir(parents=True)
    save_reference_checkpoint(path, params, config=to_dict(cfg))
    return path


def _with_jax_noise(monkeypatch, seed: int, N: int):
    """The port's pc_sample, handed the draws the JAX CLI makes for the
    utterance (or batch) whose index seeds the call's generator."""
    calls = []
    sample = pc_mod.pc_sample

    def patched(sde, score_fn, y, *args, **kw):
        idx = kw["generator"].initial_seed()  # step_generator(seed=0, idx)
        calls.append((idx, tuple(y.shape)))
        key = jax.random.fold_in(jax.random.PRNGKey(seed), idx)
        kw["noise"] = jax_pc_noise(key, (y.shape[0], 2, y.shape[-1]), N)
        return sample(sde, score_fn, y, *args, **kw)

    monkeypatch.setattr(pc_mod, "pc_sample", patched)
    return calls


def _outputs(out_dir: Path, split="test"):
    (d,) = [p for p in out_dir.iterdir() if p.is_dir()]
    return d.name, json.loads((d / f"{split}.json").read_text()), json.loads((d / f"{split}_summary.json").read_text())


@pytest.mark.parametrize("mode", [[], ["--batch-size", "2"]], ids=["per-utterance", "batched"])
def test_evaluate_mp_matches_the_jax_cli(run, tmp_path, monkeypatch, mode):
    argv = [str(run), "-N", "2", *mode]
    jax_evaluate_mp_main(argv + ["-d", "0", "1", "-o", str(tmp_path / "jax")])
    calls = _with_jax_noise(monkeypatch, seed=0, N=2)
    cli.main(argv + ["-d", "cpu", "cpu", "-o", str(tmp_path / "port")])
    if mode:  # worker 0: one batch of the 1.3 s pair (2 s bucket); worker 1: the 0.6 s file, padded to 2 rows
        assert sorted(calls) == [(0, (2, 1, 16000)), (2, (2, 1, 8000))]
    else:
        assert sorted(calls) == [(0, (1, 1, 10400)), (1, (1, 1, 10400)), (2, (1, 1, 4800))]
    name_j, want, summary_j = _outputs(tmp_path / "jax")
    name_p, got, summary_p = _outputs(tmp_path / "port")
    assert name_p == name_j and list(got) == list(want) == ["0", "1", "2"]
    for k in want:
        g, w = got[k], want[k]
        assert set(g) == set(w) == RECORD_KEYS
        for key in RECORD_KEYS - {"runtime"}:
            if key in TOL:
                assert np.shape(g[key]) == np.shape(w[key]), key
                np.testing.assert_allclose(g[key], w[key], atol=TOL[key], err_msg=key)
            else:
                assert g[key] == w[key], key
    assert set(summary_p) == set(summary_j) and summary_p["number"] == summary_j["number"] == 3


def test_no_proc_matches_the_jax_cli(tmp_path, monkeypatch):
    write_wsj0_mix(tmp_path / "data" / "wsj0_mix", {"val": 3}, seconds=0.7, fs=16000, seed=6)
    monkeypatch.chdir(tmp_path)
    jax_evaluate_mp_main(["__no_proc__", "--splits", "val", "-d", "0", "1", "-o", "jax"])
    cli.main(["__no_proc__", "--splits", "val", "-d", "cpu", "cpu", "-o", "port"])
    name_j, want, summary_j = _outputs(tmp_path / "jax", "val")
    name_p, got, summary_p = _outputs(tmp_path / "port", "val")
    assert name_p == name_j == "mix"
    assert got == want and summary_p == summary_j


def test_a_pinned_sampler_is_the_default(run, tmp_path):
    """A run whose config pins a sampler (a distilled stage's: ddim / none /
    N=2 on the log grid) is evaluated at it without sampler flags, and its
    result dir names it; flags still override it."""
    pinned = tmp_path / "pinned.ckpt"
    blob = torch.load(run, map_location="cpu", weights_only=False)
    config = blob["hyper_parameters"]["config"]
    config["model"]["sampler"] = dict(config["model"].get("sampler") or {}, predictor_name="ddim",
                                      corrector_name="none", N=2, schedule="log")
    torch.save(blob, pinned)
    out = cli.main([str(pinned), "-d", "cpu", "-l", "1", "-o", str(tmp_path / "out")])
    _, records, _ = _outputs(tmp_path / "out")
    assert out.name.endswith("N-2_snr-0.5_corrstep-1_denoise-True_schedule-log_pred-ddim_corr-none")
    assert records["0"]["nfe"] == 2  # ddim, no corrector: one evaluation per step
    out = cli.main([str(pinned), "-d", "cpu", "-l", "1", "-N", "3", "-o", str(tmp_path / "out3")])
    assert "_N-3_" in out.name and json.loads((out / "test.json").read_text())["0"]["nfe"] == 3
