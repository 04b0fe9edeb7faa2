"""The port's folder CLI (diffsep_tpu_torch/cli/separate.py) against the JAX
package's (diffsep_tpu/cli/separate.py) on the CPU, and its flags end to
end.

Both CLIs read the same reference-layout checkpoint of the tiny float32
model. The JAX CLI normalizes each file on its true length, zero-pads it to
whole seconds, samples, cuts back and projects the raw mixture onto the
estimates; the port is handed the JAX sampler's draws for the padded shape.
The written sources agree at 1e-3 of their scale (the tolerance of
tests/test_torch_port_sampling.py), where sampling at the file's own length
(what the port's CLI did before) misses by far more.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_port_util import JAX_TINY_OVERRIDES, jax_pc_noise, one_torch_thread, random_params  # noqa: F401
from diffsep_tpu.cli.separate import main as jax_separate_main
from diffsep_tpu.config import compose
from diffsep_tpu.config.compose import to_dict
from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel
from diffsep_tpu.models.convert import save_reference_checkpoint
from diffsep_tpu_torch.cli import separate as cli
from diffsep_tpu_torch.cli.loading import load_model
from diffsep_tpu_torch.data.audio_io import load_wav, save_wav
from diffsep_tpu_torch.sampling import pc as pc_mod
from diffsep_tpu_torch.sampling import pc_sample
from diffsep_tpu_torch.train.losses import normalize_batch

REL = 1e-3
FS = 8000
N_SAMPLES = 10400  # 1.3 s: padded to the 2 s bucket


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = compose(JAX_TINY_OVERRIDES)
    params = random_params(JaxDiffSepModel(cfg).score_model, np.random.default_rng(31))
    path = tmp_path_factory.mktemp("ref") / "checkpoint.ckpt"
    save_reference_checkpoint(path, params, config=to_dict(cfg))
    return path


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("in")
    mix = (np.random.default_rng(32).standard_normal((1, N_SAMPLES)) * 0.6 + 0.03).astype(np.float32)
    save_wav(d / "mix.wav", mix, FS)
    return d


def _with_noise(monkeypatch, noise, shape):
    """The port's pc_sample, handed `noise` where it samples `shape`."""
    seen = []

    def patched(sde, score_fn, y, *args, **kw):
        seen.append(tuple(y.shape))
        if tuple(y.shape[::2]) == shape[::2]:
            kw["noise"] = noise
        return pc_sample(sde, score_fn, y, *args, **kw)

    monkeypatch.setattr(pc_mod, "pc_sample", patched)
    return seen


def test_folder_cli_matches_the_jax_cli(ckpt, folder, tmp_path, monkeypatch):
    seed, N = 3, 2
    jax_separate_main([str(folder), str(tmp_path / "jax"), "--model", str(ckpt), "-N", str(N), "--seed", str(seed)])
    padded = 2 * FS
    noise = jax_pc_noise(jax.random.fold_in(jax.random.PRNGKey(seed), 0), (1, 2, padded), N)
    seen = _with_noise(monkeypatch, noise, (1, 2, padded))
    cli.main([str(folder), str(tmp_path / "port"), "--model", str(ckpt), "-N", str(N), "--seed", str(seed),
              "--device", "cpu"])
    assert seen == [(1, 1, padded)]  # sampled once, at the bucket's length
    want = np.concatenate([load_wav(tmp_path / "jax" / f"s{i}" / "mix.wav")[0] for i in (0, 1)])
    got = np.concatenate([load_wav(tmp_path / "port" / f"s{i}" / "mix.wav")[0] for i in (0, 1)])
    assert got.shape == want.shape == (2, N_SAMPLES)
    tol = REL * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol)

    # sampled at the file's own length with the same draws cut to it, the
    # network sees other STFT frames: the result is another separation
    model = load_model(ckpt, device="cpu")
    mix = torch.from_numpy(load_wav(folder / "mix.wav")[0][None])
    (mix_n, _), _, _ = normalize_batch(mix)
    cut = {k: v[..., :N_SAMPLES] for k, v in noise.items()}
    with torch.no_grad():
        est, _ = pc_sample(model.sde, model.score_fn, mix_n, N=N, eps=model.t_eps, noise=cut)
    unpadded = cli.scale_output(mix.numpy(), est.numpy())[0]
    assert np.abs(unpadded - want).max() > 10 * tol


def test_flags_reach_the_sampler(ckpt, folder, tmp_path, monkeypatch):
    seen = {}

    def fake(sde, score_fn, y, predictor_name, corrector_name, **kw):
        seen.update(kw, predictor=predictor_name, corrector=corrector_name, shape=tuple(y.shape))
        return torch.zeros(y.shape[0], 2, y.shape[-1]), 0

    monkeypatch.setattr(pc_mod, "pc_sample", fake)
    cli.main([str(folder), str(tmp_path / "o"), "--model", str(ckpt), "-N", "7", "--snr", "0.25",
              "--corrector-steps", "2", "--denoise", "false", "-s", "log", "--predictor", "dpmpp",
              "--corrector", "none", "--device", "cpu"])
    assert seen["predictor"] == "dpmpp" and seen["corrector"] == "none"
    assert seen["N"] == 7 and seen["snr"] == 0.25 and seen["corrector_steps"] == 2
    assert seen["denoise"] is False and seen["schedule"] == "log" and seen["shape"] == (1, 1, 2 * FS)
    seen.clear()
    cli.main([str(folder), str(tmp_path / "o2"), "--model", str(ckpt), "--device", "cpu"])
    assert seen["predictor"] == "reverse_diffusion" and seen["corrector"] == "ald2"
    assert seen["denoise"] is True and seen["N"] is None and "snr" not in seen


def test_denoise_false_and_streaming_end_to_end(ckpt, folder, tmp_path):
    for name, extra in (("plain", ["--denoise", "false"]),
                        ("stream", ["--stream-chunk-s", "0.5", "--stream-overlap-s", "0.1"])):
        cli.main([str(folder), str(tmp_path / name), "--model", str(ckpt), "-N", "2", "--device", "cpu", *extra])
        for s in ("s0", "s1"):
            wav, fs = load_wav(tmp_path / name / s / "mix.wav")
            assert fs == FS and wav.shape == (1, N_SAMPLES) and np.isfinite(wav).all()


def test_wrong_sample_rate_is_skipped(ckpt, tmp_path):
    (tmp_path / "in").mkdir()
    save_wav(tmp_path / "in" / "hi.wav", np.zeros((1, 1600), np.float32), 16000)
    cli.main([str(tmp_path / "in"), str(tmp_path / "out"), "--model", str(ckpt), "--device", "cpu"])
    assert not (tmp_path / "out" / "s0").exists()


def test_model_path_errors(tmp_path):
    (tmp_path / "in").mkdir()
    with pytest.raises(FileNotFoundError, match="not a local path"):
        cli.main([str(tmp_path / "in"), str(tmp_path / "out"), "--model", str(tmp_path / "nope"), "--device", "cpu"])
    art = tmp_path / "model.dsx"
    art.write_bytes(cli.ARTIFACT_MAGIC + b"rest")
    with pytest.raises(NotImplementedError, match="export artifact"):
        cli.main([str(tmp_path / "in"), str(tmp_path / "out"), "--model", str(art), "--device", "cpu"])


def test_separate_needs_cuda_unless_cpu_is_asked(ckpt, folder, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([str(folder), str(tmp_path / "out"), "--model", str(ckpt)])
    assert not (tmp_path / "out").exists()


def test_the_artifact_magic_is_the_jax_packages():
    from diffsep_tpu.export import _MAGIC

    assert cli.ARTIFACT_MAGIC == _MAGIC


def test_avg_last_k_over_a_run_dir(tmp_path):
    """--avg-last-k reaches load_model: two checkpoints' EMA weights are
    averaged for the separation."""
    import yaml

    from _torch_port_util import PORT_TINY_CONFIG
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.train.checkpoints import CheckpointManager

    base = DiffSepModel(PORT_TINY_CONFIG, device="cpu").score_model.state_dict()
    run = tmp_path / "run"
    run.mkdir()
    (run / "hparams.yaml").write_text(yaml.safe_dump({"config": {"model": PORT_TINY_CONFIG}}))
    mgr = CheckpointManager(run / "checkpoints")
    for step in (1, 2):
        mgr.save(step, {"model": base, "train_state": {"ema": {"params": {k: v + step for k, v in base.items()}}},
                        "config": {"model": PORT_TINY_CONFIG}})
    (tmp_path / "in").mkdir()
    save_wav(tmp_path / "in" / "a.wav", np.random.default_rng(0).standard_normal((1, 900)).astype(np.float32), FS)
    loaded = []
    orig = cli.load_model

    def spy(*a, **kw):
        loaded.append(orig(*a, **kw))
        return loaded[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "load_model", spy)
        cli.main([str(tmp_path / "in"), str(tmp_path / "out"), "--model", str(run), "--avg-last-k", "2",
                  "-N", "1", "--predictor", "ddim", "--corrector", "none", "-s", "log", "--device", "cpu"])
    k = next(iter(base))
    torch.testing.assert_close(loaded[0].score_model.state_dict()[k], base[k] + 1.5)
    assert (tmp_path / "out" / "s1" / "a.wav").exists()
