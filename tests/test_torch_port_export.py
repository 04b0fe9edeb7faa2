"""The port's export artifact (diffsep_tpu_torch/export.py,
cli/export_model.py, cli/serve.py's ArtifactEngine, cli/separate.py's
artifact branch) on the CPU: the counterparts of tests/test_export.py, the
custom ops the export traces, the serving entry points on an artifact, and
the artifact against the JAX package.

Tolerances: the artifact against the live ``separate_masked`` on the same
seed within 1e-5 of scale (the same ops in the same order: bit for bit
measured); the artifact handed the JAX sampler's draws against
``diffsep_tpu``'s ``separate_masked`` within 1e-3 of scale, the tolerance
of tests/test_torch_port_masked.py.
"""
import argparse
import json
import os
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import JAX_TINY_OVERRIDES, PORT_TINY_CONFIG, jax_pc_noise, random_params
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from diffsep_tpu_torch.cli import export_model as export_cli
from diffsep_tpu_torch.cli import separate as separate_cli
from diffsep_tpu_torch.cli import serve as serve_cli
from diffsep_tpu_torch.cli.loading import load_model
from diffsep_tpu_torch.data.audio_io import load_wav, save_wav
from diffsep_tpu_torch.export import _MAGIC, export_separator, load_separator
from diffsep_tpu_torch.models import layers
from diffsep_tpu_torch.ops import conv3x3, fir_resample2x

SAME, JAX_REL = 1e-5, 1e-3
FS = 8000
TAPS = (0.125, 0.375, 0.375, 0.125)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """Two training steps of the tiny model through the training entry point."""
    from diffsep_tpu_torch.cli import train as train_cli
    from diffsep_tpu_torch.data.synthetic import write_wsj0_mix
    from test_torch_port_serve import TINY_TRAIN

    data = write_wsj0_mix(tmp_path_factory.mktemp("wsj0_mix"), {"train": 2, "val": 2}, seconds=0.5, seed=0)
    exp = tmp_path_factory.mktemp("exp")
    train_cli.main(["experiment=icassp-separation", f"path.datasets.wsj0_mix={data}", f"path.exp_root={exp}",
                    *TINY_TRAIN])
    (run,) = [p for p in (exp / "default").iterdir() if p.is_dir()]
    return run


@pytest.fixture(scope="module")
def model(run_dir):
    return load_model(run_dir, device="cpu")


def _mix(batch, n, seed=0):
    return (np.random.default_rng(seed).standard_normal((batch, 1, n)) * 0.1).astype(np.float32)


SAMPLERS = {
    "reverse_diffusion+ald2": dict(N=2, predictor_name="reverse_diffusion", corrector_name="ald2"),
    "ddim log": dict(N=2, predictor_name="ddim", corrector_name="none", schedule="log"),
    "dpmpp log": dict(N=3, predictor_name="dpmpp", corrector_name="none", schedule="log"),
    "euler_maruyama+langevin raw": dict(N=2, predictor_name="euler_maruyama", corrector_name="langevin",
                                        denoise=False),
}
BATCH, N_SAMPLES = 2, FS // 2  # the static shape of the shared artifacts


@pytest.fixture(scope="module")
def exported(model, tmp_path_factory):
    """Artifacts of ``model`` at (BATCH, N_SAMPLES), by sampler, exported once
    for the module: {sampler: path}."""
    d, paths = tmp_path_factory.mktemp("art"), {}

    def get(sampler):
        if sampler not in paths:
            paths[sampler] = d / f"{len(paths)}.dst"
            export_separator(model, BATCH, N_SAMPLES, out_path=paths[sampler], **SAMPLERS[sampler])
        return paths[sampler]

    return get


@pytest.fixture(scope="module")
def artifact(exported):
    return exported("ddim log")


# --------------------------------------------------------------------------
# the custom ops
# --------------------------------------------------------------------------
def _op_cases():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 8, 10, 16), generator=g, requires_grad=True)
    w = torch.randn((3, 3, 16, 8), generator=g, requires_grad=True)
    b = torch.randn((8,), generator=g, requires_grad=True)
    odd = torch.randn((1, 7, 9, 8), generator=g, requires_grad=True)
    return {
        "conv3x3": (conv3x3._conv3x3_op, (x, w, b)),
        "conv3x3 no bias": (conv3x3._conv3x3_op, (x, w, None)),
        "fir_down2x": (fir_resample2x._fir_down2x_op, (x, TAPS, False)),
        "fir_down2x odd": (fir_resample2x._fir_down2x_op, (odd, TAPS, False)),
        "fir_up2x": (fir_resample2x._fir_up2x_op, (x, tuple(4 * t for t in TAPS), (0, 0), False)),
    }


@pytest.mark.parametrize("case", list(_op_cases()))
def test_custom_ops_pass_opcheck(case):
    """Schema, fake implementation and autograd registration of each op."""
    op, args = _op_cases()[case]
    torch.library.opcheck(op, args)


def test_export_traces_each_kernel_call_as_one_node(model, artifact, monkeypatch):
    """The exported step holds one node of each custom op per kernel call of
    an evaluation (ddim: one evaluation per step)."""
    calls = {"conv3x3": 0, "fir_down2x": 0, "fir_up2x": 0}
    forward, resample = conv3x3._forward, fir_resample2x._resample

    def count_conv(*args):
        calls["conv3x3"] += 1
        return forward(*args)

    def count_fir(x, taps, up, **kw):
        calls["fir_up2x" if up else "fir_down2x"] += 1
        return resample(x, taps, up, **kw)

    x = torch.from_numpy(_mix(2, 4000).reshape(1, 2, 4000))
    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(conv3x3, "_forward", count_conv)
        m.setattr(fir_resample2x, "_resample", count_fir)
        model.score_fn(x, torch.full((1,), 0.5), torch.from_numpy(_mix(1, 4000)))
    sep = load_separator(artifact)
    nodes = [str(n.target) for n in sep._step.graph.nodes if n.op == "call_function"]
    got = {k: nodes.count(f"diffsep.{k}.default") for k in calls}
    assert got == calls and calls["conv3x3"] > 0 and calls["fir_down2x"] > 0
    assert not any(n.op == "call_function" and "diffsep" in str(n.target)
                   for p in (sep._prelude, sep._epilogue) for n in p.graph.nodes)
    assert not layers._weights_in_graph


# --------------------------------------------------------------------------
# the port's counterparts of tests/test_export.py
# --------------------------------------------------------------------------
@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_export_roundtrip_matches_separate_masked(model, exported, sampler):
    kw = SAMPLERS[sampler]
    sep = load_separator(exported(sampler))
    assert sep.meta["n_speakers"] == 2 and sep.meta["sampler"]["N"] == kw["N"]
    assert sep.batch == BATCH and sep.n_samples == N_SAMPLES and sep.meta["device"] == "cpu"
    assert sep.meta["param_bytes"] == sum(p.numel() * 4 for p in model.score_model.parameters())
    mix = _mix(BATCH, N_SAMPLES)
    got = sep.call(7, mix)
    want, _ = model.separate_masked(mix, [N_SAMPLES] * BATCH, generator=torch.Generator().manual_seed(7), **kw)
    assert got.shape == (BATCH, 2, N_SAMPLES)
    torch.testing.assert_close(got, want, atol=SAME * want.abs().max().item(), rtol=0)


def test_export_seed_determinism_and_shape_contract(exported):
    sep = load_separator(exported("reverse_diffusion+ald2").read_bytes())  # the bytes
    mix = _mix(BATCH, N_SAMPLES)
    a, b, c = sep.call(3, mix), sep.call(3, mix), sep.call(4, mix)
    assert torch.equal(a, b) and (a - c).abs().max() > 0
    for bad in (_mix(BATCH + 1, N_SAMPLES), _mix(BATCH, N_SAMPLES - 1)):
        with pytest.raises(ValueError, match="static serving contract"):
            sep.call(0, bad)


def test_export_rejects_garbage(exported, tmp_path):
    p = tmp_path / "bad.dst"
    p.write_bytes(b"not an artifact")
    with pytest.raises(ValueError, match="bad magic"):
        load_separator(p)
    meta = json.dumps({"spec_version": 99}).encode()
    p.write_bytes(_MAGIC + struct.pack("<I", len(meta)) + meta + b"x")
    with pytest.raises(ValueError, match="spec_version"):
        load_separator(p)
    # the JAX package's StableHLO artifact: not the port's format, and the
    # CLIs say so
    jax_art = tmp_path / "jax.dsx"
    jax_art.write_bytes(separate_cli.ARTIFACT_MAGIC + b"...")
    with pytest.raises(ValueError, match="bad magic"):
        load_separator(jax_art)
    (tmp_path / "in").mkdir()
    with pytest.raises(NotImplementedError, match="export artifact of the JAX package.*queue 1 item 4"):
        separate_cli.main([str(tmp_path / "in"), str(tmp_path / "out"), "--model", str(jax_art), "--device", "cpu"])
    # an artifact serves on the device type it was exported on
    with pytest.raises(ValueError, match="exported on cpu"):
        load_separator(exported("reverse_diffusion+ald2"), device="cuda")


def test_export_cli(run_dir, tmp_path):
    out = tmp_path / "cli.dst"
    export_cli.main([str(run_dir), "-o", str(out), "--batch", "1", "--len-s", "0.5", "-N", "2", "--predictor",
                     "dpmpp", "--corrector", "none", "--schedule", "log", "--device", "cpu"])
    sep = load_separator(out)
    assert sep.n_samples == sep.meta["fs"] // 2
    assert sep.meta["sampler"]["predictor_name"] == "dpmpp" and sep.meta["sampler"]["schedule"] == "log"
    est = sep.call(0, _mix(1, sep.n_samples))
    assert est.shape == (1, 2, sep.n_samples) and torch.isfinite(est).all()


def test_separate_masked_full_length_equals_separate(model):
    mix = _mix(BATCH, N_SAMPLES)
    kw = SAMPLERS["reverse_diffusion+ald2"]
    want, _ = model.separate(mix, generator=torch.Generator().manual_seed(5), **kw)
    got, _ = model.separate_masked(mix, [N_SAMPLES] * BATCH, generator=torch.Generator().manual_seed(5), **kw)
    torch.testing.assert_close(got, want, atol=SAME * want.abs().max().item(), rtol=0)


def test_export_variable_length_rows(model, exported):
    """Padded rows: normalization on each row's true span, as
    separate_masked, and a zero pad region."""
    n, n_true = N_SAMPLES, 2500
    sep = load_separator(exported("reverse_diffusion+ald2"))
    mix = _mix(BATCH, n)
    mix[1, :, n_true:] = 0.0
    n_valid = np.array([n, n_true])
    got = sep.call(11, mix, n_valid)
    want, _ = model.separate_masked(mix, n_valid, generator=torch.Generator().manual_seed(11),
                                    **SAMPLERS["reverse_diffusion+ald2"])
    torch.testing.assert_close(got, want, atol=SAME * want.abs().max().item(), rtol=0)
    assert (got[1, :, n_true:] == 0).all() and got[1, :, :n_true].abs().max() > 0
    with pytest.raises(ValueError, match="n_valid"):
        sep.call(0, mix, np.array([n]))


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("in")
    rng = np.random.default_rng(2)
    for name, n in (("a", 3000), ("b", 4000), ("c", 1000)):
        save_wav(d / f"{name}.wav", (rng.standard_normal((1, n)) * 0.1).astype(np.float32), FS)
    return d


def test_separate_cli_from_artifact(artifact, wavs, tmp_path):
    """cli.separate --model ARTIFACT: the folder through the artifact's static
    contract, each file at its own length, s<i>/<stem>.wav; each estimate
    equals the artifact's own on the row as the engine pads it."""
    out = tmp_path / "out"
    separate_cli.main([str(wavs), str(out), "--model", str(artifact), "--device", "cpu"])
    for name, n in (("a", 3000), ("b", 4000), ("c", 1000)):
        for s in ("s0", "s1"):
            wav, sr = load_wav(out / s / f"{name}.wav")
            assert sr == FS and wav.shape == (1, n) and np.isfinite(wav).all()
    for flags in (["-N", "4"], ["--denoise", "false"], ["--stream-chunk-s", "1"]):
        with pytest.raises(SystemExit, match="baked at export"):
            separate_cli.main([str(wavs), str(out), "--model", str(artifact), "--device", "cpu", *flags])


def test_serve_stdin_from_artifact(artifact, wavs, tmp_path, capsys, monkeypatch):
    """cli.serve's stdin loop on an ArtifactEngine: one DONE per request, a
    request longer than the artifact's length refused alone."""
    long_wav = tmp_path / "long.wav"
    save_wav(long_wav, np.zeros((1, FS), np.float32) + 0.01, FS)
    paths = [wavs / "a.wav", wavs / "b.wav", long_wav, wavs / "c.wav"]
    r, w = os.pipe()
    with os.fdopen(w, "w") as wf:
        wf.write("".join(f"{p}\n" for p in paths))
    rf = os.fdopen(r, "r")
    monkeypatch.setattr(sys, "stdin", rf)
    try:
        serve_cli.main([str(tmp_path / "out"), "--model", str(artifact), "--device", "cpu"])
    finally:
        rf.close()
    lines = capsys.readouterr().out.splitlines()
    assert sorted(line.split()[1] for line in lines if line.startswith("DONE")) == sorted(
        str(p) for p in paths if p != long_wav)
    assert [line.split()[1] for line in lines if line.startswith("ERROR")] == [str(long_wav)]
    for name, n in (("a", 3000), ("b", 4000), ("c", 1000)):
        assert load_wav(tmp_path / "out" / "s1" / f"{name}.wav")[0].shape == (1, n)


def test_artifact_engine_rows_equal_the_artifact(artifact, wavs):
    """The engine pads a request into a row, passes its length as n_valid
    and projects the mixture onto the row's estimates."""
    eng = serve_cli.ArtifactEngine(load_separator(artifact), seed=5)
    mix = load_wav(wavs / "a.wav")[0]
    (est,) = eng._run_bucket([mix])
    rows = np.zeros((2, 1, FS // 2), np.float32)
    rows[0, :, :3000] = mix
    want = eng.sep.call((5 * 1_000_003 + 1) & 0x7FFFFFFF, rows, np.array([3000, FS // 2])).numpy()
    np.testing.assert_allclose(est, separate_cli.scale_output(mix[None], want[:1, :, :3000])[0], rtol=0, atol=0)


def test_serve_rejects_sampler_flags_for_an_artifact(artifact, tmp_path):
    for flags in (["-N", "4"], ["--predictor", "ddim"], ["--snr", "0.3"]):
        args = argparse.Namespace(model=artifact, device="cpu", seed=0, predictor=None, corrector=None, N=None,
                                  snr=None, corrector_steps=None)
        for flag, value in zip(flags[::2], flags[1::2]):
            setattr(args, {"-N": "N", "--predictor": "predictor", "--snr": "snr"}[flag], value)
        with pytest.raises(SystemExit, match="baked into the artifact"):
            serve_cli._engine_from_args(args)


# --------------------------------------------------------------------------
# the artifact against the JAX package
# --------------------------------------------------------------------------
def test_artifact_with_the_jax_draws_matches_jax():
    """reverse_diffusion + ald2: the prior, corrector and predictor draws all
    go in."""
    from diffsep_tpu.config import compose
    from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.models import state_dict_from_jax

    jmodel = JaxDiffSepModel(compose(JAX_TINY_OVERRIDES))
    params = random_params(jmodel.score_model, np.random.default_rng(13))
    tmodel = DiffSepModel(PORT_TINY_CONFIG, device="cpu")
    tmodel.score_model.load_state_dict(state_dict_from_jax(params), strict=True)
    kw = SAMPLERS["reverse_diffusion+ald2"]
    mix = (np.random.default_rng(5).standard_normal((2, 1, 1000)) * 0.3 + 0.1).astype(np.float32)
    mix[1, :, 650:] = 0.0
    n_valid = np.array([1000, 650])
    key = jax.random.PRNGKey(17)
    want, _ = jmodel.separate_masked(params, key, jnp.asarray(mix), jnp.asarray(n_valid), **kw)
    want = np.asarray(want)
    sep = load_separator(export_separator(tmodel, 2, 1000, **kw))
    got = sep.call(0, mix, n_valid, noise=jax_pc_noise(key, (2, 2, 1000), kw["N"])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_REL * np.abs(want).max())
