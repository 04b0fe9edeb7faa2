"""The port's training entry point end to end on the CPU, at a tiny size:
``diffsep_tpu_torch.cli.train.main`` with ``trainer.accelerator=cpu`` on a
seeded synthetic WSJ0-mix folder: train, validate, checkpoint, resume and
warm start."""
import json
import math
from pathlib import Path

import pytest
import torch

from diffsep_tpu_torch.cli import train as train_cli
from diffsep_tpu_torch.data.synthetic import write_wsj0_mix
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

TINY = [
    "trainer.accelerator=cpu", "model.score_model.backbone_args.nf=8",
    "model.score_model.backbone_args.ch_mult=[1,2,2]", "model.score_model.backbone_args.num_res_blocks=1",
    "model.score_model.backbone_args.attn_resolutions=[]", "model.score_model.backbone_args.dtype=float32",
    "model.score_model.stft_args.n_fft=126", "model.score_model.stft_args.hop_length=32",
    "model.sampler.N=2", "model.sde.N=2", "model.valid_max_sep_batches=1",
    "datamodule.train.dl_opts.batch_size=2", "datamodule.val.dl_opts.batch_size=2",
    "trainer.check_val_every_n_epoch=1",
]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_wsj0_mix(tmp_path_factory.mktemp("wsj0_mix"), {"train": 4, "val": 2}, seconds=0.5, seed=0)


def _main(data, exp_root, *extra):
    return train_cli.main(["experiment=icassp-separation", f"path.datasets.wsj0_mix={data}",
                           f"path.exp_root={exp_root}", *TINY, *extra])


def _run_dir(exp_root: Path) -> Path:
    (run,) = [p for p in (exp_root / "default").iterdir() if p.is_dir()]
    return run


def test_train_validate_checkpoint_resume(data, tmp_path):
    state = _main(data, tmp_path / "exp", "trainer.max_steps=4")
    assert state.step == 4 and state.ema.num_updates == 2  # accumulate_grad_batches 2
    run = _run_dir(tmp_path / "exp")
    rows = [json.loads(line) for line in (run / "train_log.jsonl").read_text().splitlines()]
    steps = [r for r in rows if "step" in r]
    assert [r["step"] for r in steps] == [1, 2, 3, 4]
    assert all(math.isfinite(r["train/score_loss"]) and r["lr"] == 2e-4 for r in steps)
    assert (run / "hparams.yaml").exists()
    ckpt = run / "checkpoints"
    index = json.loads((ckpt / "index.json").read_text())
    assert sorted(index) == ["2", "4"] and all(math.isfinite(m["val/si_sdr"]) for m in index.values())
    assert (ckpt / "latest.pt").resolve().name == "4.pt"
    assert (ckpt / "best-model.pt").resolve().name in ("2.pt", "4.pt")

    # resume: the same run's state goes on from step 4
    resumed = _main(data, tmp_path / "exp2", "trainer.max_steps=6", f"trainer.resume_from_checkpoint={run}")
    assert resumed.step == 6 and resumed.ema.num_updates == 3
    assert resumed.optimizer.count == 3

    # warm start: the pretrained weights, a fresh optimizer
    score_cfg, params, ema = train_cli.load_pretrained(run)
    assert score_cfg["backbone_args"]["nf"] == 8 and params.keys() == ema.keys()
    warm = _main(data, tmp_path / "exp3", "trainer.max_steps=2", f"load_pretrained={run}")
    assert warm.step == 2 and warm.optimizer.count == 1
    payload = torch.load(ckpt / "4.pt", map_location="cpu", weights_only=True)
    assert payload["train_state"]["step"] == 4


@pytest.mark.parametrize("override,error", [
    ("trainer.accelerator=tpu", ValueError),
])
def test_unported_options_raise(data, tmp_path, override, error):
    with pytest.raises(error):
        _main(data, tmp_path / "exp", override)


def test_test_true_scores_the_test_split(data, tmp_path):
    """test=true after training: the test split with the EMA weights, in
    the JAX CLI's records (cli/evaluate.py)."""
    write_wsj0_mix(data, {"test": 2}, seconds=0.5, seed=1)
    state = _main(data, tmp_path / "exp", "trainer.max_steps=2", "test=true", "datamodule.test.dl_opts.batch_size=1")
    assert state.step == 2
    results = _run_dir(tmp_path / "exp") / "test_results"
    records = json.loads((results / "test.json").read_text())
    assert len(records) == 2 and all(len(r["si_sdr"][0]) == 2 and r["nfe"] == 4 for r in records)
    assert json.loads((results / "test_summary.json").read_text())["number"] == 2
