"""Checkpoint loading of the inference CLIs (diffsep_tpu_torch/cli/loading.py).

A port run dir (the layout diffsep_tpu_torch.cli.train writes: hparams.yaml,
checkpoints/<step>.pt, index.json, best-model.pt and latest.pt) with three
checkpoints whose EMA weights are base, base+3, base+6 and raw weights
base, base+6, base+12 goes through the cases of
tests/test_checkpoint_averaging.py. A reference-layout Lightning checkpoint
written by diffsep_tpu.models.convert.save_reference_checkpoint, with an EMA
shadow list added, loads into the same parameters in both packages, raw and
EMA (exact: both only copy float32 values).
"""
import logging

import jax
import numpy as np
import pytest
import torch
import yaml

from _torch_port_util import JAX_TINY_OVERRIDES, PORT_TINY_CONFIG, one_torch_thread, random_params  # noqa: F401
from diffsep_tpu.cli.loading import load_model as jax_load_model
from diffsep_tpu.config import compose
from diffsep_tpu.config.compose import to_dict
from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel
from diffsep_tpu.models.convert import save_reference_checkpoint
from diffsep_tpu_torch.cli import loading
from diffsep_tpu_torch.cli.loading import load_model, resolve_avg_steps
from diffsep_tpu_torch.model import DiffSepModel
from diffsep_tpu_torch.models import state_dict_from_jax
from diffsep_tpu_torch.train.checkpoints import CheckpointManager

TOL = 1e-6


@pytest.fixture(scope="module")
def run_with_three_checkpoints(tmp_path_factory):
    base = {k: v.clone() for k, v in DiffSepModel(PORT_TINY_CONFIG, device="cpu").score_model.state_dict().items()}
    run = tmp_path_factory.mktemp("port_run")
    (run / "hparams.yaml").write_text(yaml.safe_dump({"config": {"model": PORT_TINY_CONFIG}}))
    mgr = CheckpointManager(run / "checkpoints")
    # step 2 is the best by val/si_sdr, step 3 the latest
    for i, (step, si_sdr) in enumerate([(1, 1.0), (2, 5.0), (3, 2.0)]):
        shift = 3.0 * i
        raw = {k: v + 2 * shift for k, v in base.items()}
        ema = {k: v + shift for k, v in base.items()}
        mgr.save(step, {"model": raw, "train_state": {"ema": {"params": ema, "num_updates": step}},
                        "config": {"model": PORT_TINY_CONFIG}}, {"val/si_sdr": si_sdr})
    return run, base


def _assert_offset(model, base, offset):
    got = model.score_model.state_dict()
    assert got.keys() == base.keys()
    for k, v in base.items():
        torch.testing.assert_close(got[k], v + offset, atol=TOL, rtol=TOL)


def test_run_dir_gives_the_best_checkpoints_ema(run_with_three_checkpoints):
    run, base = run_with_three_checkpoints
    _assert_offset(load_model(run, device="cpu"), base, 3.0)
    _assert_offset(load_model(run, use_ema=False, device="cpu"), base, 6.0)
    _assert_offset(load_model(run / "checkpoints", device="cpu"), base, 3.0)


def test_checkpoint_file_pins_its_step(run_with_three_checkpoints):
    run, base = run_with_three_checkpoints
    _assert_offset(load_model(run / "checkpoints" / "1.pt", device="cpu"), base, 0.0)
    _assert_offset(load_model(run / "checkpoints" / "latest.pt", device="cpu"), base, 6.0)
    _assert_offset(load_model(run, step=3, use_ema=False, device="cpu"), base, 12.0)


def test_avg_last_k_means_recent_ema(run_with_three_checkpoints):
    run, base = run_with_three_checkpoints
    _assert_offset(load_model(run, avg_last_k=2, device="cpu"), base, 4.5)
    _assert_offset(load_model(run, avg_last_k=3, device="cpu"), base, 3.0)


def test_avg_last_k_more_than_available_warns_and_averages_all(run_with_three_checkpoints, caplog):
    run, base = run_with_three_checkpoints
    with caplog.at_level(logging.WARNING):
        model = load_model(run, avg_last_k=10, device="cpu")
    _assert_offset(model, base, 3.0)
    assert any("avg_last_k" in r.message for r in caplog.records)


def test_avg_last_k_raw_params(run_with_three_checkpoints):
    run, base = run_with_three_checkpoints
    _assert_offset(load_model(run, avg_last_k=2, use_ema=False, device="cpu"), base, 9.0)


def test_avg_last_k_anchored_at_step(run_with_three_checkpoints):
    run, base = run_with_three_checkpoints
    _assert_offset(load_model(run, step=2, avg_last_k=2, device="cpu"), base, 1.5)
    _assert_offset(load_model(run / "checkpoints" / "2.pt", avg_last_k=2, device="cpu"), base, 1.5)


def test_resolve_avg_steps(run_with_three_checkpoints):
    run, _ = run_with_three_checkpoints
    assert resolve_avg_steps(run, 2) == [2, 3]
    assert resolve_avg_steps(run, 10) == [1, 2, 3]
    assert resolve_avg_steps(run, 2, step=2) == [1, 2]
    assert resolve_avg_steps(run / "checkpoints" / "2.pt", 5) == [1, 2]
    with pytest.raises(FileNotFoundError, match="at or before"):
        resolve_avg_steps(run, 2, step=0)


def test_avg_last_k_rejects_a_single_file(tmp_path):
    f = tmp_path / "x.ckpt"
    f.write_bytes(b"")
    with pytest.raises(ValueError, match="avg_last_k"):
        load_model(f, avg_last_k=2, device="cpu")
    with pytest.raises(FileNotFoundError, match="hparams.yaml"):
        load_model(tmp_path / "nothing_here", device="cpu")


@pytest.fixture(scope="module")
def reference_checkpoint(tmp_path_factory):
    """A reference-layout checkpoint of the tiny model: raw weights from the
    JAX package's writer, and an ema.shadow_params list (raw + 1) over the
    trainable keys in state_dict order, as the reference saves it."""
    cfg = compose(JAX_TINY_OVERRIDES)
    params = random_params(JaxDiffSepModel(cfg).score_model, np.random.default_rng(21))
    path = tmp_path_factory.mktemp("ref") / "checkpoint.ckpt"
    save_reference_checkpoint(path, params, config=to_dict(cfg))
    ckpt = torch.load(path, weights_only=False)
    sd = ckpt["state_dict"]
    trainable = [k for k in sd if ".stft" not in k and not k.endswith("all_modules.0.W")]
    ckpt["ema"] = {"shadow_params": [sd[k] + 1.0 for k in trainable]}
    torch.save(ckpt, path)
    return path, params


@pytest.mark.parametrize("use_ema", [True, False], ids=["ema", "raw"])
def test_reference_checkpoint_loads_the_same_in_both_packages(reference_checkpoint, use_ema):
    path, params = reference_checkpoint
    _, jparams = jax_load_model(path, use_ema=use_ema)
    want = state_dict_from_jax(jax.device_get(jparams))
    model = load_model(path, use_ema=use_ema, device="cpu")
    got = model.score_model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)
    raw = state_dict_from_jax(params)
    for k in ("backbone.all_modules.0.W", "backbone.all_modules.1.weight"):
        offset = 1.0 if use_ema and not k.endswith("0.W") else 0.0  # the Fourier W is not averaged
        torch.testing.assert_close(got[k], raw[k] + offset, atol=TOL, rtol=TOL)
    # the reference hparams' targets name the port's classes
    bb = model.config["score_model"]["backbone_args"]
    assert bb["nf"] == 8 and bb["_target_"] == "diffsep_tpu_torch.models.NCSNpp"


def test_reference_ema_list_of_the_wrong_length_raises(reference_checkpoint, tmp_path):
    path, _ = reference_checkpoint
    ckpt = torch.load(path, weights_only=False)
    ckpt["ema"]["shadow_params"] = ckpt["ema"]["shadow_params"][:-1]
    torch.save(ckpt, tmp_path / "bad.ckpt")
    with pytest.raises(ValueError, match="EMA shadow list"):
        load_model(tmp_path / "bad.ckpt", device="cpu")


@pytest.mark.parametrize("target", ["sdes.sdes.PriorMixSDE", "sdes.sdes.OUVESDE", "models.losses.PESQ",
                                    "sdes.sdes.OUVPSDE"])
def test_unported_reference_targets_raise(target):
    """The enhancement recipe's reference targets, which raised until the
    port had their classes, now name those classes, and build."""
    from diffsep_tpu_torch.config.compose import instantiate

    hparams = {"config": {"model": {"sde": {"_target_": target}}}}
    got = loading._config_from_hparams(hparams)["model"]["sde"]["_target_"]
    assert got == "diffsep_tpu_torch." + ("models.losses." if "losses" in target else "sde.") + target.rpartition(".")[2]
    assert type(instantiate({"_target_": got})).__name__ == target.rpartition(".")[2]


def test_port_weights_file_and_bare_state_dict(tmp_path):
    model = DiffSepModel(PORT_TINY_CONFIG, device="cpu", seed=3)
    sd = model.score_model.state_dict()
    torch.save({"state_dict": sd, "config": PORT_TINY_CONFIG}, tmp_path / "w.pt")
    got = load_model(tmp_path / "w.pt", device="cpu").score_model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    config, raw, ema = loading.read_checkpoint(tmp_path / "w.pt")
    assert config == PORT_TINY_CONFIG and ema is None
    torch.save(sd, tmp_path / "bare.pt")
    config, raw, ema = loading.read_checkpoint(tmp_path / "bare.pt")
    assert config is None and ema is None and raw.keys() == sd.keys()
