"""The enhancement recipe's training loss, and its train, validate and test
path end to end on the CPU at a tiny size.

The loss: the noise-reduction recipe's (PriorMixSDE, init hack 4, no source
reordering) on a tiny NCSN++ with seeded random weights, against the JAX
package's, value and parameter gradients, with the JAX draws rebuilt from
the same key (``jax_loss_draws``). Tolerances as tests/test_torch_port_losses.py
holds the separation recipe's: the loss within 1e-5 of its value, every
parameter gradient within 1e-4 of the global gradient norm.

The entry point: ``diffsep_tpu_torch.cli.train.main experiment=noise-reduction
trainer.accelerator=cpu test=true`` on a seeded synthetic VCTK-DEMAND
folder trains, validates (val/si_sdr, val/pesq), checkpoints, scores the
test split into ``test_results/test.json`` with the JAX CLI's schema, and
resumes.
"""
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import jax_loss_draws, jax_score_model, load_port_weights, port_score_model, random_params
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from diffsep_tpu.sde.mixsde import PriorMixSDE as JaxPriorMixSDE
from diffsep_tpu.train import losses as jax_losses
from diffsep_tpu_torch.cli import train as train_cli
from diffsep_tpu_torch.data.synthetic import write_vctk_demand
from diffsep_tpu_torch.models import state_dict_from_jax
from diffsep_tpu_torch.sde import PriorMixSDE
from diffsep_tpu_torch.train import losses

B, T = 4, 1200
N_STEPS = 3  # init hack 4 pins 1/N of the batch to t = T
RECORD_KEYS = {"batch_idx", "si_sdr", "si_sir", "si_sar", "pesq", "stoi", "nfe", "runtime", "len_s"}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    jm = jax_score_model()
    params = random_params(jm, rng)
    pm = port_score_model()
    load_port_weights(pm, params)
    clean = rng.standard_normal((B, 1, T)).astype(np.float32)
    noise = 0.5 * rng.standard_normal((B, 1, T)).astype(np.float32)
    noise[:, :, 300:700] *= 0.01  # the envelope of the noisy mixture varies
    # the network jitted once for the module; the loss around it runs op by op
    return dict(net=jax.jit(jm.apply), params=params, pm=pm, mix=clean + noise,
                tgt=np.concatenate([clean, noise], axis=1))  # [clean, noisy - clean]


# both keys pin item 0 of the 4 to t = T (init hack 4, p = 1/N)
@pytest.mark.parametrize("key_seed,weighted", [(1, False), (4, True)])
def test_nr_training_loss_and_gradients_match_jax(setup, key_seed, weighted):
    s = setup
    weight = np.array([1.0, 0.0, 2.0, 0.5], np.float32) if weighted else None
    key = jax.random.PRNGKey(key_seed)
    kw = dict(t_eps=0.03, init_hack=4, train_source_order="None", time_strategy="uniform")

    def jax_loss(p):
        return jax_losses.training_loss(
            key, JaxPriorMixSDE(N=N_STEPS), lambda x, t, m: s["net"]({"params": p}, x, t, m),
            jnp.asarray(s["mix"]), jnp.asarray(s["tgt"]),
            sample_weight=None if weight is None else jnp.asarray(weight), **kw)

    want, grads = jax.value_and_grad(jax_loss)(s["params"])
    draws = jax_loss_draws(key, s["tgt"].shape, init_hack=4, order="None")
    assert set(draws) == {"time", "z", "select"}
    pm = s["pm"]
    pm.zero_grad(set_to_none=True)
    got = losses.training_loss(
        losses.Draws(given=draws), PriorMixSDE(N=N_STEPS), pm, torch.from_numpy(s["mix"]),
        torch.from_numpy(s["tgt"]), sample_weight=None if weight is None else torch.from_numpy(weight), **kw)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    want_g = state_dict_from_jax(grads)
    got_g = {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in pm.named_parameters()}
    norm = torch.sqrt(sum((g ** 2).sum() for g in want_g.values())).item()
    assert norm > 0
    err = max((got_g[k] - want_g[k]).abs().max().item() for k in want_g)
    assert err <= 1e-4 * norm, err / norm


TINY = [
    "trainer.accelerator=cpu", "model.score_model.backbone_args.nf=8",
    "model.score_model.backbone_args.ch_mult=[1,2,2]", "model.score_model.backbone_args.num_res_blocks=1",
    "model.score_model.backbone_args.attn_resolutions=[]", "model.score_model.backbone_args.dtype=float32",
    "model.score_model.stft_args.n_fft=126", "model.score_model.stft_args.hop_length=32",
    "model.sampler.N=2", "model.sde.N=2", "datamodule.train.dl_opts.batch_size=2",
    "datamodule.val.dl_opts.batch_size=2", "datamodule.train.dataset.audio_len=0.5",
    "trainer.accumulate_grad_batches=2",
]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    # 5 train files: 4 train + 1 val after the 90/10 split; lengths 0.3-1 s
    return write_vctk_demand(tmp_path_factory.mktemp("vctk"), n_train=5, n_test=2, seed=0, seconds=(0.3, 1.0))


def _main(data, exp_root, *extra):
    return train_cli.main(["experiment=noise-reduction", f"path.datasets.valentini={data}",
                           f"path.exp_root={exp_root}", *TINY, *extra])


def test_train_validate_test_and_resume(data, tmp_path):
    state = _main(data, tmp_path / "exp", "trainer.max_steps=4", "test=true")
    assert state.step == 4 and state.ema.num_updates == 2
    (run,) = [p for p in (tmp_path / "exp" / "enhancement").iterdir() if p.is_dir()]
    index = json.loads((run / "checkpoints" / "index.json").read_text())
    assert sorted(index) == ["2", "4"]
    for metrics in index.values():
        assert math.isfinite(metrics["val/si_sdr"]) and math.isfinite(metrics["val/score_loss"])
        assert "val/pesq" not in metrics or math.isfinite(metrics["val/pesq"])
    records = json.loads((run / "test_results" / "test.json").read_text())
    summary = json.loads((run / "test_results" / "test_summary.json").read_text())
    assert len(records) == 2 and all(set(r) == RECORD_KEYS for r in records)
    assert all(len(r["si_sdr"]) == 1 and len(r["si_sdr"][0]) == 2 for r in records)  # nested, 2 sources
    assert all(r["nfe"] == 4 and np.isfinite(r["stoi"]).all() for r in records)
    assert set(summary) == RECORD_KEYS | {"number"} and summary["number"] == 2
    assert sorted(p.name for p in (run / "test_results" / "wav" / "test").iterdir())[:2] == [
        "000_enh0.wav", "000_enh1.wav"]

    resumed = _main(data, tmp_path / "exp2", "trainer.max_steps=6", f"trainer.resume_from_checkpoint={run}")
    assert resumed.step == 6 and resumed.ema.num_updates == 3


def test_test_without_training_scores_fresh_weights(data, tmp_path):
    state = _main(data, tmp_path / "exp", "train=false", "test=true")
    assert state.step == 0
    (run,) = [p for p in (tmp_path / "exp" / "enhancement").iterdir() if p.is_dir()]
    assert len(json.loads((run / "test_results" / "test.json").read_text())) == 2


def test_a_failing_validation_metric_does_not_end_training(data, tmp_path, monkeypatch, caplog):
    """PESQ raises on a clip under 250 ms or a silent one: the loop logs it
    and leaves the metric out, as the JAX loop does."""
    from diffsep_tpu_torch.models import losses as metric_losses

    def fail(self, est, ref):
        raise ValueError("PESQ needs at least 250 ms")

    monkeypatch.setattr(metric_losses.PESQ, "__call__", fail)
    state = _main(data, tmp_path / "exp", "trainer.max_steps=4")
    assert state.step == 4
    (run,) = [p for p in (tmp_path / "exp" / "enhancement").iterdir() if p.is_dir()]
    index = json.loads((run / "checkpoints" / "index.json").read_text())
    assert all("val/pesq" not in m and math.isfinite(m["val/si_sdr"]) for m in index.values())
    assert "val metric val/pesq failed: PESQ needs at least 250 ms" in caplog.text


def test_an_enhancement_run_serves_16_khz_files(data, tmp_path):
    """cli.separate and cli.serve (--watch --once) enhance 16 kHz files with
    the run dir: the speech and the noise at each file's own length."""
    from diffsep_tpu_torch.cli import separate as separate_cli
    from diffsep_tpu_torch.cli import serve as serve_cli
    from diffsep_tpu_torch.data.audio_io import load_wav

    _main(data, tmp_path / "exp", "trainer.max_steps=2")
    (run,) = [p for p in (tmp_path / "exp" / "enhancement").iterdir() if p.is_dir()]
    noisy = data / "test" / "noisy"
    for name, cli in (("separate", separate_cli), ("serve", serve_cli)):
        out = tmp_path / name
        args = [str(noisy), str(out)] if name == "separate" else [str(out), "--watch", str(noisy), "--once"]
        cli.main(args + ["--model", str(run), "--device", "cpu", "-N", "2"])
        for f in sorted(noisy.iterdir()):
            n = load_wav(f)[0].shape[-1]
            for src in range(2):
                est, fs = load_wav(out / f"s{src}" / f.name)
                assert fs == 16000 and est.shape == (1, n) and np.isfinite(est).all(), (name, f.name)
