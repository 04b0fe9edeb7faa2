"""``cli.export_model --torch`` and ``--avg-last-k`` of the port against the
JAX package, on the CPU.

One run is written twice from the same JAX train state, as three
checkpoints whose EMA weights are base, base + 3 and base + 6: a JAX run dir
(orbax, the JAX package's own layout) and the port's run dir (each state
carried by ``train_state_from_jax``). Then:
  * ``--torch`` writes a reference ``.ckpt``: the JAX loader reads the
    port's EMA weights from it bit for bit, and the port's loader too; the
    same weights written by the JAX ``save_reference_checkpoint`` with the
    JAX package's config of the same overrides give the same keys, the same
    values bit for bit and the same mapped config (targets the reference
    has no class for keep their package's name, ``diffsep_tpu`` or
    ``diffsep_tpu_torch``);
  * ``--avg-last-k 2 --torch`` holds the mean of the last two checkpoints'
    EMA weights, equal to the JAX ``load_model(avg_last_k=2)`` on the JAX
    run dir within 1e-6 (the JAX test's tolerance: the port averages in
    float64, the JAX package in float32); ``--avg-last-k 2`` exports an
    artifact that samples as the averaged model does (within 1e-3 of scale:
    these offset weights drive the output to ~3e8) and not as the last
    checkpoint does;
  * sampler flags are refused with ``--torch``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from diffsep_tpu.cli.loading import load_model as jax_load_model
from diffsep_tpu.config import compose as jax_compose
from diffsep_tpu.config.compose import to_dict as jax_to_dict
from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel
from diffsep_tpu.models.convert import save_reference_checkpoint as jax_save_reference_checkpoint
from diffsep_tpu.train.checkpoints import CheckpointManager as JaxCheckpointManager
from diffsep_tpu_torch.cli import export_model
from diffsep_tpu_torch.cli.loading import load_model
from diffsep_tpu_torch.config import compose
from diffsep_tpu_torch.config.compose import to_dict
from diffsep_tpu_torch.model import DiffSepModel
from diffsep_tpu_torch.models import state_dict_from_jax, train_state_from_jax
from diffsep_tpu_torch.train.checkpoints import CheckpointManager

TINY = [
    "model.score_model.backbone_args.nf=8", "model.score_model.backbone_args.ch_mult=[1,2]",
    "model.score_model.backbone_args.num_res_blocks=1", "model.score_model.backbone_args.attn_resolutions=[16]",
    "model.score_model.backbone_args.image_size=64", "model.score_model.stft_args.n_fft=126",
    "model.score_model.stft_args.hop_length=32", "model.score_model.backbone_args.dtype=float32",
]
OFFSETS = {1: 0.0, 2: 3.0, 3: 6.0}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("export_torch")
    jcfg = jax_compose(TINY)
    jmodel = JaxDiffSepModel(jcfg)
    mix = jnp.zeros((1, 1, 2000), jnp.float32) + 0.01
    state = jmodel.init_state(jax.random.PRNGKey(0), mix, jnp.zeros((1, 2, 2000), jnp.float32))
    jax_run, port_run = tmp / "jax_run", tmp / "port_run"
    jax_run.mkdir()
    (jax_run / "hparams.yaml").write_text(yaml.safe_dump({"config": jax_to_dict(jcfg)}))
    cfg = compose(TINY)
    port_run.mkdir()
    (port_run / "hparams.yaml").write_text(yaml.safe_dump({"config": to_dict(cfg)}))
    jmgr = JaxCheckpointManager(jax_run / "checkpoints", best_symlink=False)
    pmgr = CheckpointManager(port_run / "checkpoints")
    for step, shift in OFFSETS.items():
        st = state.replace(step=jnp.asarray(step),
                           params=jax.tree_util.tree_map(lambda a: a + 2 * shift, state.params),
                           ema=state.ema._replace(params=jax.tree_util.tree_map(lambda a: a + shift,
                                                                                  state.ema.params)))
        jmgr.save(step, st)
        model = DiffSepModel(cfg, device="cpu")
        pstate = train_state_from_jax(jax.device_get(st), model)
        pmgr.save(step, {"model": model.score_model.state_dict(), "train_state": pstate.state_dict(),
                         "config": to_dict(cfg)}, {})
    jmgr.close()
    return jax_run, port_run, jcfg, jax.device_get(state.ema.params)


def _ema_of_last(port_run):
    blob = torch.load(port_run / "checkpoints" / "3.pt", map_location="cpu", weights_only=False)
    return blob["train_state"]["ema"]["params"]


def test_torch_ckpt_is_read_by_both_loaders(runs, tmp_path):
    _, port_run, _, base = runs
    out = tmp_path / "model.ckpt"
    export_model.main([str(port_run), "-o", str(out), "--torch", "--device", "cpu"])
    ema = _ema_of_last(port_run)  # the latest checkpoint: no metric ranks them
    _, params = jax_load_model(out)
    got = state_dict_from_jax(jax.device_get(params))
    assert got.keys() == ema.keys()
    assert all(torch.equal(got[k], ema[k]) for k in ema)
    back = load_model(out, device="cpu").score_model.state_dict()
    assert all(torch.equal(back[k], ema[k]) for k in ema)
    ref = state_dict_from_jax(jax.tree_util.tree_map(lambda a: a + 6.0, base))
    assert all(torch.equal(ref[k], ema[k]) for k in ema)


def _unprefixed(node):
    if isinstance(node, dict):
        return {k: (v.replace("diffsep_tpu_torch.", "diffsep_tpu.") if k == "_target_" and isinstance(v, str)
                    else _unprefixed(v)) for k, v in node.items()}
    if isinstance(node, list):
        return [_unprefixed(v) for v in node]
    return node


def test_torch_ckpt_equals_the_jax_writer(runs, tmp_path):
    jax_run, port_run, jcfg, _ = runs
    ours, theirs = tmp_path / "ours.ckpt", tmp_path / "theirs.ckpt"
    export_model.main([str(port_run), "-o", str(ours), "--torch", "--device", "cpu"])
    _, params = jax_load_model(jax_run)
    jax_save_reference_checkpoint(theirs, jax.device_get(params), config=jax_to_dict(jcfg))
    a, b = (torch.load(p, map_location="cpu", weights_only=False) for p in (ours, theirs))
    assert set(a) == set(b) == {"state_dict", "global_step", "epoch", "hyper_parameters"}
    assert a["state_dict"].keys() == b["state_dict"].keys()
    assert all(torch.equal(a["state_dict"][k], b["state_dict"][k]) for k in b["state_dict"])
    ca, cb = a["hyper_parameters"]["config"], b["hyper_parameters"]["config"]
    assert ca["model"]["score_model"]["_target_"] == "models.score_models.ScoreModelNCSNpp"
    assert ca["model"]["sde"]["_target_"] == "sdes.sdes.MixSDE"
    assert _unprefixed(ca["model"]) == _unprefixed(cb["model"])
    assert set(ca) == set(cb)


def test_avg_last_k_equals_jax(runs, tmp_path):
    jax_run, port_run, _, base = runs
    out = tmp_path / "avg.ckpt"
    export_model.main([str(port_run), "-o", str(out), "--torch", "--avg-last-k", "2", "--device", "cpu"])
    got = load_model(out, device="cpu").score_model.state_dict()
    _, params = jax_load_model(jax_run, avg_last_k=2)
    want = state_dict_from_jax(jax.device_get(params))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-6)
    mean = state_dict_from_jax(jax.tree_util.tree_map(lambda a: a + 4.5, base))
    for k in mean:
        np.testing.assert_allclose(got[k].numpy(), mean[k].numpy(), rtol=1e-6, atol=1e-6)


def test_avg_last_k_artifact_holds_the_mean(runs, tmp_path):
    _, port_run, _, _ = runs
    from diffsep_tpu_torch.export import load_separator

    out = tmp_path / "avg.dst"
    export_model.main([str(port_run), "-o", str(out), "--avg-last-k", "2", "--device", "cpu", "--batch", "1",
                       "--len-s", "0.25", "-N", "1", "--predictor", "ddim", "--corrector", "none"])
    want = load_model(port_run, avg_last_k=2, device="cpu")
    sep = load_separator(out)
    rng = np.random.default_rng(1)
    mix = torch.from_numpy(rng.standard_normal((1, 1, 2000)).astype(np.float32) * 0.1)
    noise = {"prior": torch.from_numpy(rng.standard_normal((1, 2, 2000)).astype(np.float32))}
    got = sep.call(0, mix, noise=noise)
    ref, _ = want.separate(mix, noise=noise, predictor_name="ddim", corrector_name="none", N=1)
    last, _ = load_model(port_run, device="cpu").separate(mix, noise=noise, predictor_name="ddim",
                                                          corrector_name="none", N=1)
    scale = float(ref.abs().max())
    # the offset weights drive the output to ~3e8, where the exported
    # program's float32 rounding reads ~4e-5 of scale against the live model
    assert float((got - ref).abs().max()) <= 1e-3 * scale < float((last - ref).abs().max())


@pytest.mark.parametrize("flag", [["-N", "4"], ["--predictor", "ddim"], ["--schedule", "log"], ["--snr", "0.3"]])
def test_sampler_flags_are_refused_with_torch(runs, tmp_path, flag):
    _, port_run, _, _ = runs
    with pytest.raises(SystemExit, match="do not apply to --torch"):
        export_model.main([str(port_run), "-o", str(tmp_path / "x.ckpt"), "--torch", "--device", "cpu", *flag])
