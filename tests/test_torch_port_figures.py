"""The port's figures CLI (cli/figures.py) on the CPU (--device cpu): the
cases of tests/test_figures.py, the curves of sde_marginal_evolution
against the JAX package's MixSDE (1e-5 of scale, float32), and
reverse_diffusion_example against the JAX package's on the same tiny
checkpoint and the same draws (the JAX sampler's from PRNGKey(0), handed to
the port), its intermediates within 1e-3 of scale (the sampling tolerance
of tests/test_torch_port_sampling.py)."""
from __future__ import annotations

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import JAX_TINY_OVERRIDES, jax_pc_noise, one_torch_thread, random_params  # noqa: F401
import diffsep_tpu.cli.eval_common as jax_eval_common
from diffsep_tpu.cli.figures import reverse_diffusion_example as jax_reverse_diffusion_example
from diffsep_tpu.config import compose
from diffsep_tpu.config.compose import to_dict
from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel
from diffsep_tpu.models.convert import save_reference_checkpoint
from diffsep_tpu.sde import MixSDE as JaxMixSDE
from diffsep_tpu_torch.cli import eval_common, figures
from diffsep_tpu_torch.cli.eval_common import sampler_run_config
from diffsep_tpu_torch.cli.loading import load_model
from diffsep_tpu_torch.data.audio_io import save_wav
from diffsep_tpu_torch.data.synthetic import write_wsj0_mix
from diffsep_tpu_torch.sampling import pc as pc_mod
from diffsep_tpu_torch.train.losses import normalize_batch

CPU = ["--device", "cpu"]
N_SAMPLES = 4000


def test_sde_marginal_evolution_synthetic(tmp_path):
    out = figures.sde_marginal_evolution(["--data", str(tmp_path / "missing"), "--out", str(tmp_path / "figs"),
                                          "--limit", "2", "--d-lambdas", "2", "4", *CPU])
    assert (tmp_path / "figs" / "paper_sde_marginal_evolution.pdf").exists()
    t = jnp.linspace(0.01, 1.0, 200)
    np.testing.assert_allclose(out["t"], np.asarray(t), atol=1e-6)
    for d_lambda in (2, 4):
        sde = JaxMixSDE(ndim=2, d_lambda=d_lambda, sigma_min=0.05, sigma_max=0.5, N=30)
        mm = np.asarray(sde._mean_mix_mat(t))
        L = np.asarray(sde._std(t))
        cov = L @ L
        c = out["curves"][d_lambda]
        for got, want in [(c["coef_diag"], mm[:, 0, 0]), (c["coef_off"], mm[:, 0, 1]),
                          (c["corr"], cov[:, 0, 1] / cov[:, 0, 0])]:
            assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())
        # the synthetic targets sum to the mixture: x_T = mix / 2 differs
        # from the mean mu_t by (A + e^{-t d} Pn) s - A s = e^{-t d} Pn s
        assert np.all(np.diff(c["error"]) < 0) and c["error"][0] > 0


def test_parse_name():
    d = figures.parse_name("exp_abc_N-30_snr-0.5_corrstep-1_denoise-True_schedule-None")
    assert d == {"N": 30, "snr": 0.5, "corrstep": 1, "denoise": True, "schedule": None}
    assert figures.parse_name("run_N-4_snr-0.1_corrstep-2_denoise-False_schedule-log_avgk-3") == {
        "N": 4, "snr": 0.1, "corrstep": 2, "denoise": False, "schedule": "log", "avgk": 3}


def _result_dirs(tmp_path, values):
    for N, (si, pq) in values.items():
        d = tmp_path / "results" / f"run_N-{N}_snr-0.5_corrstep-1_denoise-True_schedule-None"
        d.mkdir(parents=True)
        (d / "test_summary.json").write_text(json.dumps({"si_sdr": si, "pesq": pq}))
    return tmp_path / "results" / "run"


def test_exp_inference(tmp_path):
    base = _result_dirs(tmp_path, {10: (9.0, 2.1), 30: (11.0, 2.3)})
    figures.exp_inference([str(base), "N", "--out", str(tmp_path / "figs"), *CPU])
    assert (tmp_path / "figs" / "exp_inference_N.pdf").exists()


def test_exp_inference_values_land_in_figure(tmp_path):
    expected = {N: (6.0 + N / 10, 1.5 + N / 50) for N in (5, 10, 30)}
    base = _result_dirs(tmp_path, expected)
    series = figures.exp_inference([str(base), "N", "--out", str(tmp_path / "figs"), *CPU])
    assert series["si_sdr"] == [(N, expected[N][0]) for N in sorted(expected)]
    assert series["pesq"] == [(N, expected[N][1]) for N in sorted(expected)]
    d = tmp_path / "results" / "run_snr-0.7_corrstep-1_denoise-True_schedule-None"
    d.mkdir()
    (d / "test_summary.json").write_text(json.dumps({"si_sdr": 99.0}))
    series = figures.exp_inference([str(base), "N", "--out", str(tmp_path / "figs"), *CPU])
    assert all(v != 99.0 for _, v in series["si_sdr"])


def test_sampler_tag_roundtrip_with_predictor():
    """The port's sampler_run_config and parse_name are two halves of one
    dirname schema."""
    def mk_args(**kw):
        base = dict(N=None, snr=None, corrector_steps=None, denoise=True, schedule=None, predictor=None,
                    corrector=None, avg_last_k=None)
        base.update(kw)
        return types.SimpleNamespace(**base)

    cfg = {"sampler": {"N": 30, "snr": 0.5, "corrector_steps": 1}}
    _, tag = sampler_run_config(cfg, mk_args(), None)
    assert "pred-" not in tag and figures.parse_name(tag)["N"] == 30
    _, tag = sampler_run_config(cfg, mk_args(predictor="reverse_diffusion", corrector="ald2"), None)
    assert "pred-" not in tag
    kw, tag = sampler_run_config(cfg, mk_args(N=6, predictor="ddim", corrector="none", schedule="log"), None)
    parsed = figures.parse_name("run_" + tag)
    assert kw["N"] == 6 and parsed["N"] == 6 and parsed["pred"] == "ddim" and parsed["corr"] == "none"
    assert parsed["schedule"] == "log"


def test_samples_picks_percentiles(tmp_path):
    res = tmp_path / "res"
    records = [{"batch_idx": i, "si_sdr": [float(s), float(s) + 1]} for i, s in enumerate([5, -2, 9, 1])]
    (res / "wav" / "test").mkdir(parents=True)
    (res / "test.json").write_text(json.dumps(records))
    rng = np.random.default_rng(0)
    for i in range(4):
        for name in ("mix", "enh0", "tgt0"):
            save_wav(res / "wav" / "test" / f"{i:03d}_{name}.wav", 0.1 * rng.standard_normal((1, 800)), 8000)
    picks = figures.samples([str(res), "--percentiles", "0", "100", "--out", str(tmp_path / "figs"), *CPU])
    assert [p["batch_idx"] for p in picks] == [1, 2]
    assert (tmp_path / "figs" / "samples_test.pdf").exists()
    keyed = {str(r["batch_idx"]): r for r in records}  # evaluate_mp's layout
    (res / "test.json").write_text(json.dumps(keyed))
    picks = figures.samples([str(res), "--percentiles", "50", "--out", str(tmp_path / "figs"), *CPU])
    assert [p["batch_idx"] for p in picks] == [3]


@pytest.mark.parametrize("sub", sorted(figures.COMMANDS))
def test_cuda_is_the_default_device(sub, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"sde_marginal_evolution": [], "reverse_diffusion_example": [str(tmp_path)],
            "samples": [str(tmp_path)], "exp_inference": [str(tmp_path / "run"), "N"]}[sub]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        figures.main([sub, *args, "--out", str(tmp_path / "figs")])


def test_main_usage():
    with pytest.raises(SystemExit):
        figures.main(["nope"])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A tiny reference-layout checkpoint and a WSJ0-mix folder with one
    validation mixture of N_SAMPLES."""
    root = tmp_path_factory.mktemp("fig")
    cfg = compose(JAX_TINY_OVERRIDES)
    params = random_params(JaxDiffSepModel(cfg).score_model, np.random.default_rng(41))
    save_reference_checkpoint(root / "checkpoint.ckpt", params, config=to_dict(cfg))
    write_wsj0_mix(root / "data", {"val": 2}, seconds=N_SAMPLES / 8000, seed=42)
    return root


def _capture(monkeypatch, module):
    seen = {}

    def save_fig(x, ims, target, out_dir, index):
        seen.update(x=np.asarray(x), ims=np.asarray(ims), target=np.asarray(target), index=index)

    monkeypatch.setattr(module, "save_fig", save_fig)
    return seen


def test_reverse_diffusion_example_matches_jax(run, tmp_path, monkeypatch):
    N = 3
    argv = [str(run / "checkpoint.ckpt"), "--data", str(run / "data"), "--out", str(tmp_path), "--index", "1",
            "-N", str(N)]
    want = _capture(monkeypatch, jax_eval_common)
    jax_reverse_diffusion_example(argv)
    noise = jax_pc_noise(jax.random.PRNGKey(0), (1, 2, N_SAMPLES), N)
    real = pc_mod.pc_sample
    monkeypatch.setattr(pc_mod, "pc_sample", lambda *a, **kw: real(*a, **{**kw, "noise": noise}))
    got = _capture(monkeypatch, eval_common)
    x, nfe, ims = figures.reverse_diffusion_example(argv + CPU)
    assert nfe == 2 * N and got["index"] == want["index"] == 1
    assert got["ims"].shape == want["ims"].shape == (N, 2, 1, 2, N_SAMPLES)
    np.testing.assert_allclose(got["target"], want["target"], atol=1e-5)
    for key in ("ims", "x"):
        scale = max(1.0, np.abs(want[key]).max())
        assert np.abs(got[key] - want[key]).max() <= 1e-3 * scale, key
    np.testing.assert_array_equal(got["x"], x.numpy())


def test_reverse_diffusion_example_samples_as_get_pc_sampler(run, tmp_path, monkeypatch):
    """The figure's sources are bit for bit those of get_pc_sampler with the
    same seed and no intermediates."""
    got = _capture(monkeypatch, eval_common)
    x, _, ims = figures.reverse_diffusion_example([str(run / "checkpoint.ckpt"), "--data", str(run / "data"),
                                                   "--out", str(tmp_path), "-N", "2", "--seed", "5", *CPU])
    assert torch.isfinite(ims).all() and torch.equal(ims[-1, 1], x)
    model = load_model(run / "checkpoint.ckpt", device="cpu")
    from diffsep_tpu_torch.data.wsj0_mix import WSJ0_mix

    mix, _ = WSJ0_mix(run / "data", 2, 8000, "max", "val")[0]
    (mix, _), _, _ = normalize_batch(torch.from_numpy(mix)[None])
    plain, _ = model.get_pc_sampler("reverse_diffusion", "ald2", mix, generator=torch.Generator().manual_seed(5),
                                    N=2, snr=0.5, corrector_steps=1)()
    assert torch.equal(plain, x) and np.array_equal(got["x"], x.numpy())
