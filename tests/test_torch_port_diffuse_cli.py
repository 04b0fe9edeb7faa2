"""``model=diffuse`` through the port's entry points on the CPU, at a tiny
width (2 layers x 8 channels), from a scratch working directory: one run
dir trained by ``cli.train`` is separated, served, evaluated, distilled and
exported by the existing CLIs without new flags, and the same recipe trains
on two gloo ranks (``trainer.devices=2``)."""
import json
import math
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from diffsep_tpu_torch.cli import distill as distill_cli
from diffsep_tpu_torch.cli import evaluate as evaluate_cli
from diffsep_tpu_torch.cli import evaluate_mp as evaluate_mp_cli
from diffsep_tpu_torch.cli import export_model as export_cli
from diffsep_tpu_torch.cli import separate as separate_cli
from diffsep_tpu_torch.cli import serve as serve_cli
from diffsep_tpu_torch.cli import train as train_cli
from diffsep_tpu_torch.cli.loading import load_model
from diffsep_tpu_torch.config import compose
from diffsep_tpu_torch.data.audio_io import load_wav
from diffsep_tpu_torch.data.synthetic import write_wsj0_mix
from diffsep_tpu_torch.export import load_separator
from diffsep_tpu_torch.model import DiffSepModel
from diffsep_tpu_torch.models import ScoreModelDiffuSE
from diffsep_tpu_torch.train.losses import normalize_batch
from diffsep_tpu_torch.train.trainer import step_generator
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

FS = 8000
TINY = [
    "model=diffuse", "trainer.accelerator=cpu", "model.score_model.backbone_args.residual_layers=2",
    "model.score_model.backbone_args.residual_channels=8", "model.score_model.backbone_args.dilation_cycle_length=2",
    "model.sampler.N=2", "datamodule.train.dl_opts.batch_size=2", "datamodule.val.dl_opts.batch_size=2",
]


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    """A scratch working directory with a synthetic WSJ0-mix folder."""
    root = tmp_path_factory.mktemp("diffuse_cli")
    write_wsj0_mix(root / "wsj0_mix", {"train": 4, "val": 2, "test": 2}, seconds=0.5, seed=0)
    return root


def _overrides(scratch, exp, *extra):
    return [*TINY, f"path.datasets.wsj0_mix={scratch / 'wsj0_mix'}", f"path.exp_root={exp}", *extra]


@pytest.fixture(scope="module")
def run(scratch):
    """(run dir, its final TrainState): cli.train for 4 micro-steps (2
    optimizer steps at accumulation 2), two validations and checkpoints."""
    with pytest.MonkeyPatch.context() as m:
        m.chdir(scratch)
        state = train_cli.main(_overrides(scratch, scratch / "exp", "trainer.max_steps=4"))
    (run_dir,) = [p for p in (scratch / "exp" / "default").iterdir() if p.is_dir()]
    return run_dir, state


@pytest.fixture
def cwd(scratch, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_train_writes_a_diffuse_run_dir(run):
    run_dir, state = run
    assert state.step == 4 and state.ema.num_updates == 2
    cfg = yaml.safe_load((run_dir / "hparams.yaml").read_text())["config"]
    assert cfg["model"]["score_model"]["_target_"].endswith("ScoreModelDiffuSE")
    assert "stft_args" not in cfg["model"]["score_model"]
    rows = [json.loads(line) for line in (run_dir / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "step" in r] == [1, 2, 3, 4]
    assert all(math.isfinite(r["train/score_loss"]) for r in rows if "step" in r)
    index = json.loads((run_dir / "checkpoints" / "index.json").read_text())
    assert sorted(index) == ["2", "4"] and all(math.isfinite(v["val/si_sdr"]) for v in index.values())
    payload = torch.load(run_dir / "checkpoints" / "latest.pt", map_location="cpu", weights_only=True)
    assert "backbone.residual_layers.1.dilated_conv.weight" in payload["model"]


def _hand_model(run_dir):
    """The run's EMA weights in a DiffSepModel built by hand from the
    recipe's composed config."""
    model = DiffSepModel(compose(TINY), device="cpu")
    payload = torch.load(run_dir / "checkpoints" / "latest.pt", map_location="cpu", weights_only=True)
    model.score_model.load_state_dict(payload["train_state"]["ema"]["params"], strict=True)
    return model


def test_separate_equals_the_model_loaded_by_hand(run, scratch, cwd):
    run_dir, _ = run
    hand = _hand_model(run_dir)
    loaded = load_model(run_dir, device="cpu")
    assert isinstance(loaded.score_model, ScoreModelDiffuSE)
    want_sd = hand.score_model.state_dict()
    assert all(torch.equal(v, want_sd[k]) for k, v in loaded.score_model.state_dict().items())
    mix = torch.from_numpy((0.1 * np.random.default_rng(1).standard_normal((1, 1, 3000))).astype(np.float32))
    got, _ = loaded.separate(mix, generator=torch.Generator().manual_seed(2))
    want, _ = hand.separate(mix, generator=torch.Generator().manual_seed(2))
    assert torch.equal(got, want)

    # the folder CLI: normalized on the true length, padded to whole
    # seconds, seeded by (seed, file index), projected onto the mixture
    mixes = scratch / "wsj0_mix" / "2speakers" / "wav8k" / "max" / "cv" / "mix"
    separate_cli.main([str(mixes), str(cwd / "out"), "--model", str(run_dir), "--device", "cpu", "--seed", "3"])
    for i, path in enumerate(sorted(mixes.glob("*.wav"))):
        x = load_wav(path)[0][:1][None]
        (x_n, _), _, _ = normalize_batch(torch.from_numpy(x))
        n = x.shape[-1]
        padded = torch.nn.functional.pad(x_n, (0, -(-n // FS) * FS - n))
        sampler = hand.get_pc_sampler("reverse_diffusion", "ald2", padded, generator=step_generator(3, i, "cpu"),
                                      denoise=True)
        est = separate_cli.scale_output(x, sampler()[0][..., :n].numpy())
        for src in range(2):
            out = load_wav(cwd / "out" / f"s{src}" / path.name)[0]
            np.testing.assert_allclose(out, np.clip(est[0, src:src + 1], -1, 1), atol=1.5 / 32768)


def test_serve_stdin(run, scratch, cwd, capsys, monkeypatch):
    run_dir, _ = run
    mixes = sorted((scratch / "wsj0_mix" / "2speakers" / "wav8k" / "max" / "tt" / "mix").glob("*.wav"))
    r, w = os.pipe()
    with os.fdopen(w, "w") as wf:
        wf.write("".join(f"{p}\n" for p in mixes))
    rf = os.fdopen(r, "r")
    monkeypatch.setattr(sys, "stdin", rf)
    try:
        serve_cli.main([str(cwd / "out"), "--model", str(run_dir), "--device", "cpu", "-N", "2"])
    finally:
        rf.close()
    lines = capsys.readouterr().out.splitlines()
    assert sorted(line.split()[1] for line in lines if line.startswith("DONE")) == sorted(map(str, mixes))
    for p in mixes:
        est = load_wav(cwd / "out" / "s1" / p.name)[0]
        assert est.shape == load_wav(p)[0][:1].shape and np.isfinite(est).all()


def _records(out_dir, split):
    (d,) = [p for p in out_dir.iterdir() if p.is_dir()]
    return json.loads((d / f"{split}.json").read_text())


def test_evaluate_val(run, cwd):
    run_dir, _ = run
    evaluate_cli.main([str(run_dir), "--val", "-N", "2", "--device", "cpu", "--save-n", "0", "-o", str(cwd / "res")])
    records = _records(cwd / "res", "val")
    assert len(records) == 2
    assert all(r["nfe"] == 4 and np.isfinite(np.asarray(r["si_sdr"], float)).all() for r in records)


def test_evaluate_mp_batched_on_two_cpu_workers(run, cwd):
    run_dir, _ = run
    evaluate_mp_cli.main([str(run_dir), "--splits", "val", "-d", "cpu", "cpu", "-N", "2", "--batch-size", "2",
                          "-o", str(cwd / "res")])
    records = _records(cwd / "res", "val")  # keyed by utterance index
    assert sorted(records) == ["0", "1"]
    assert all(np.isfinite(np.asarray(r["si_sdr"], float)).all() for r in records.values())


def test_distill_and_export_then_separate_the_artifact(run, scratch, cwd):
    run_dir, _ = run
    distill_cli.main([str(run_dir), "--stages", "2", "--steps", "2", "--schedule", "log", "--out",
                      str(cwd / "distilled"), "--device", "cpu", "--log-every", "1"])
    stage = cwd / "distilled" / "N2"
    cfg = yaml.safe_load((stage / "hparams.yaml").read_text())["config"]
    assert cfg["model"]["sampler"] == {"predictor_name": "ddim", "corrector_name": "none", "N": 2, "schedule": "log"}
    art = cwd / "n2.dst"
    export_cli.main([str(stage), "-o", str(art), "--batch", "1", "--len-s", "1", "--device", "cpu"])
    sep = load_separator(art)
    assert sep.meta["sampler"]["N"] == 2 and sep.meta["n_samples"] == FS
    student = load_model(stage, device="cpu")
    mix = (0.1 * np.random.default_rng(4).standard_normal((1, 1, FS))).astype(np.float32)
    want, _ = student.separate_masked(torch.from_numpy(mix), [6000], generator=torch.Generator().manual_seed(5))
    assert torch.equal(sep.call(5, mix, [6000]), want)
    mixes = scratch / "wsj0_mix" / "2speakers" / "wav8k" / "max" / "cv" / "mix"
    separate_cli.main([str(mixes), str(cwd / "out"), "--model", str(art), "--device", "cpu"])
    for p in mixes.glob("*.wav"):
        est = load_wav(cwd / "out" / "s0" / p.name)[0]
        assert est.shape == (1, 4000) and np.isfinite(est).all()


def test_devices_2_trains_two_gloo_ranks(scratch, cwd):
    assert train_cli.main(_overrides(scratch, cwd / "exp", "trainer.devices=2", "trainer.max_steps=2",
                                     "datamodule.train.dl_opts.batch_size=1")) is None
    (run_dir,) = list((cwd / "exp" / "default").iterdir())
    logged = [json.loads(line)["step"] for line in (run_dir / "train_log.jsonl").read_text().splitlines()
              if '"step"' in line]
    assert logged == [1, 2]
    assert sorted(json.loads((run_dir / "checkpoints" / "index.json").read_text())) == ["2"]
    load_model(run_dir, device="cpu")
