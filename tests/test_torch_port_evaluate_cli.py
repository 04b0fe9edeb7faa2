"""The port's evaluation CLI (diffsep_tpu_torch/cli/evaluate.py) against the
JAX package's (diffsep_tpu/cli/evaluate.py) on the CPU.

Both CLIs read the same reference-layout checkpoint of the tiny float32
model, with the run's config (its datamodule included), and score the same
synthetic folders. The port is handed the JAX sampler's draws for each
utterance's padded shape (``fold_in(PRNGKey(seed), index)``, as the JAX CLI
keys them). Each utterance is normalized on its true length, padded to
whole seconds and sampled: the test files are 1.3 s and 0.7 s, so a wrong
order (padding first) shows in PriorMixSDE's envelope and in the
statistics. The records agree: SI-SDR, SI-SIR and SI-SAR within 0.01 dB,
STOI within 1e-3 and PESQ within 0.01 (the estimates agree at 1e-3 of
their scale, the tolerance of tests/test_torch_port_sampling.py); the
other keys exactly, runtime aside. ``__no_proc__`` scores the mixture
itself: identical records.
"""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_port_util import JAX_TINY_OVERRIDES, jax_pc_noise, one_torch_thread, random_params  # noqa: F401
from diffsep_tpu.cli.evaluate import main as jax_evaluate_main
from diffsep_tpu.config import compose
from diffsep_tpu.config.compose import to_dict
from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel
from diffsep_tpu.models.convert import save_reference_checkpoint
from diffsep_tpu_torch.cli import evaluate as cli
from diffsep_tpu_torch.data.audio_io import save_wav
from diffsep_tpu_torch.data.synthetic import write_wsj0_mix
from diffsep_tpu_torch.sampling import pc as pc_mod

RECORD_KEYS = {"batch_idx", "si_sdr", "si_sir", "si_sar", "pesq", "stoi", "nfe", "runtime", "len_s"}
TOL = {"si_sdr": 0.01, "si_sir": 0.01, "si_sar": 0.01, "stoi": 1e-3, "pesq": 0.01}


def _enhance_folder(root: Path) -> Path:
    rng = np.random.default_rng(41)
    for i, seconds in enumerate((1.3, 0.7)):
        n = int(seconds * 16000)
        clean = (0.3 * np.sin(2 * np.pi * 440 * np.arange(n) / 16000) * np.hanning(n)).astype(np.float32)
        noise = (0.05 * rng.standard_normal(n)).astype(np.float32)
        save_wav(root / "test" / "clean" / f"u{i}.wav", clean[None], 16000)
        save_wav(root / "test" / "noisy" / f"u{i}.wav", (clean + noise)[None], 16000)
    (root / "train" / "noisy").mkdir(parents=True)
    return root


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Reference checkpoints of the tiny model: the enhancement recipe on a
    VCTK-DEMAND-like folder, and the separation recipe on WSJ0-mix."""
    tmp = tmp_path_factory.mktemp("eval")
    vctk = _enhance_folder(tmp / "vctk")
    wsj = write_wsj0_mix(tmp / "wsj0_mix", {"val": 1, "test": 1}, seconds=1.3, seed=4)
    out = {}
    for name, overrides in (
        ("enhance", ["experiment=noise-reduction", *JAX_TINY_OVERRIDES[1:], f"path.datasets.valentini={vctk}"]),
        ("separate", [*JAX_TINY_OVERRIDES, f"path.datasets.wsj0_mix={wsj}"]),
    ):
        cfg = compose(overrides)
        params = random_params(JaxDiffSepModel(cfg).score_model, np.random.default_rng(42))
        path = tmp / name / "checkpoints" / "last.ckpt"
        path.parent.mkdir(parents=True)
        save_reference_checkpoint(path, params, config=to_dict(cfg))
        out[name] = path
    return out


def _with_jax_noise(monkeypatch, seed: int, N: int, corrector_steps: int = 1):
    """The port's pc_sample, handed the draws the JAX CLI makes for the
    i-th utterance it samples."""
    calls = []
    sample = pc_mod.pc_sample

    def patched(sde, score_fn, y, *args, **kw):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), len(calls))
        calls.append(tuple(y.shape))
        kw["noise"] = jax_pc_noise(key, (y.shape[0], 2, y.shape[-1]), N, corrector_steps)
        return sample(sde, score_fn, y, *args, **kw)

    monkeypatch.setattr(pc_mod, "pc_sample", patched)
    return calls


def _records(out_dir: Path, split: str):
    (run,) = [p for p in out_dir.iterdir() if p.is_dir()]
    records = json.loads((run / f"{split}.json").read_text())
    summary = json.loads((run / f"{split}_summary.json").read_text())
    return run.name, records, summary


def _same_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) == RECORD_KEYS
        for k in RECORD_KEYS - {"runtime"}:
            if k in TOL:
                assert np.shape(g[k]) == np.shape(w[k]), k
                np.testing.assert_allclose(g[k], w[k], atol=TOL[k], err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("sampler", [["--predictor", "ddim", "--corrector", "none", "-s", "log"], []],
                         ids=["ddim-none", "reverse_diffusion-ald2"])
def test_enhance_matches_the_jax_cli(runs, tmp_path, monkeypatch, sampler):
    argv = [str(runs["enhance"]), "--enhance", "--test", "-N", "2", "--save-n", "0", *sampler]
    jax_evaluate_main(argv + ["-o", str(tmp_path / "jax")])
    calls = _with_jax_noise(monkeypatch, seed=0, N=2)
    cli.main(argv + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    assert sorted(calls) == [(1, 1, 16000), (1, 1, 32000)]  # 0.7 s and 1.3 s, padded to whole seconds
    name_j, want, summary_j = _records(tmp_path / "jax", "test")
    name_p, got, summary_p = _records(tmp_path / "port", "test")
    assert name_p == name_j
    _same_records(got, want)
    assert all(len(r["si_sdr"]) == 1 and len(r["si_sdr"][0]) == 1 for r in got)  # nested, the speech only
    assert set(summary_p) == set(summary_j) == RECORD_KEYS | {"number"} and summary_p["number"] == 2


def test_separation_val_and_test_match_the_jax_cli(runs, tmp_path, monkeypatch):
    argv = [str(runs["separate"]), "-N", "2", "--save-n", "1"]
    jax_evaluate_main(argv + ["--val", "--test", "-o", str(tmp_path / "jax")])
    for split in ("val", "test"):  # the JAX CLI keys each split's utterances from 0
        with monkeypatch.context() as m:
            _with_jax_noise(m, seed=0, N=2)
            cli.main(argv + [f"--{split}", "-o", str(tmp_path / "port"), "--device", "cpu"])
    for split in ("val", "test"):
        _, want, _ = _records(tmp_path / "jax", split)
        _, got, summary = _records(tmp_path / "port", split)
        _same_records(got, want)
        assert len(got[0]["si_sdr"][0]) == 2 and summary["number"] == 1
    (run,) = [p for p in (tmp_path / "port").iterdir() if p.is_dir()]
    assert sorted(p.name for p in (run / "wav" / "val").iterdir()) == [
        "000_enh0.wav", "000_enh1.wav", "000_mix.wav", "000_tgt0.wav", "000_tgt1.wav"]


def test_no_proc_sentinel_matches_the_jax_cli(tmp_path, monkeypatch):
    write_wsj0_mix(tmp_path / "data" / "wsj0_mix", {"val": 2}, seconds=0.6, fs=16000, seed=5)
    monkeypatch.chdir(tmp_path)
    jax_evaluate_main(["__no_proc__", "--val", "-o", "jax"])
    cli.main(["__no_proc__", "--val", "-o", "port"])
    name_j, want, summary_j = _records(tmp_path / "jax", "val")
    name_p, got, summary_p = _records(tmp_path / "port", "val")
    assert name_p == name_j == "mix" and got == want and summary_p == summary_j
    assert all(r["nfe"] == 0 and r["runtime"] == 0.0 for r in got)


def test_needs_a_split_and_the_card_unless_cpu_is_asked(runs, monkeypatch):
    with pytest.raises(SystemExit):
        cli.main([str(runs["enhance"]), "--enhance"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([str(runs["enhance"]), "--enhance", "--test"])
