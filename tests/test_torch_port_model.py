"""diffsep_tpu_torch DiffSepModel.separate and the separation CLI vs
diffsep_tpu, end to end on the CPU in float32, plus the device policy of
the entry points.

separate() normalizes the mixture, samples and denormalizes; the port gets
the JAX sampler's draws, and the estimates agree at 1e-3 of their scale
(the tolerance of tests/test_torch_port_sampling.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from _torch_port_util import (
    JAX_TINY_OVERRIDES, PORT_TINY_CONFIG, jax_pc_noise, random_params,
)
from diffsep_tpu.config import compose
from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel
from diffsep_tpu_torch import resolve_device
from diffsep_tpu_torch.cli import separate as cli
from diffsep_tpu_torch.model import FLAGSHIP, DiffSepModel
from diffsep_tpu_torch.models import state_dict_from_jax

REL = 1e-3


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxDiffSepModel(compose(JAX_TINY_OVERRIDES))
    params = random_params(jmodel.score_model, np.random.default_rng(3))
    tmodel = DiffSepModel(PORT_TINY_CONFIG, device="cpu")
    tmodel.score_model.load_state_dict(state_dict_from_jax(params), strict=True)
    return jmodel, params, tmodel


def test_flagship_defaults_match_the_jax_recipe():
    cfg = compose(["experiment=icassp-separation"]).model
    bb = cfg.score_model.backbone_args
    mine = FLAGSHIP["score_model"]
    assert mine["backbone_args"]["nf"] == bb.nf == 128
    assert mine["backbone_args"]["dtype"] == bb.dtype == "bfloat16"
    assert mine["spec_factor"] == cfg.score_model.spec_factor
    assert mine["spec_abs_exponent"] == cfg.score_model.spec_abs_exponent
    assert FLAGSHIP["sampler"] == dict(cfg.sampler)
    assert FLAGSHIP["t_eps"] == cfg.t_eps
    for k in ("d_lambda", "sigma_min", "sigma_max", "N"):
        assert FLAGSHIP["sde"][k] == cfg.sde[k]


def test_separate_matches(pair, rng):
    """The production sampler (reverse_diffusion + ald2 from the recipe)."""
    jmodel, params, tmodel = pair
    kw = dict(N=2)
    mix = (rng.standard_normal((2, 1, 1000)) * 0.3 + 0.1).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want, jnfe = jmodel.separate(params, key, jnp.asarray(mix), **kw)
    want = np.asarray(want)
    noise = jax_pc_noise(key, (2, 2, 1000), kw["N"])
    got, nfe = tmodel.separate(torch.from_numpy(mix), noise=noise, **kw)
    assert nfe == int(jnfe)
    assert got.shape == want.shape == (2, 2, 1000)
    np.testing.assert_allclose(got.numpy(), want, atol=REL * np.abs(want).max())


def test_separate_uses_the_recipe_sampler_settings(pair, monkeypatch):
    """snr 0.5 and N from the config, not pc_sample's defaults."""
    _, _, tmodel = pair
    seen = {}

    def fake(sde, score_fn, y, **kw):
        seen.update(kw)
        return torch.zeros(y.shape[0], 2, y.shape[-1]), 0

    monkeypatch.setattr("diffsep_tpu_torch.model.pc_sample", fake)
    tmodel.separate(torch.zeros(1, 1, 100) + torch.arange(100.0))
    assert seen["snr"] == 0.5 and seen["N"] == 30 and seen["corrector_steps"] == 1
    assert seen["predictor_name"] == "reverse_diffusion" and seen["corrector_name"] == "ald2"
    assert seen["eps"] == 0.03


def test_low_n_linear_grid_warns(pair):
    _, _, tmodel = pair
    with pytest.warns(UserWarning, match="schedule='log'"):
        tmodel.separate(torch.randn(1, 1, 600), predictor_name="ddim",
                        corrector_name="none", N=2)


def test_cli_separates_a_folder(pair, tmp_path, rng):
    _, params, _ = pair
    model_path = tmp_path / "model.pt"
    torch.save({"state_dict": state_dict_from_jax(params), "config": PORT_TINY_CONFIG}, model_path)
    (tmp_path / "in").mkdir()
    for name in ("a", "b"):
        sig = (rng.standard_normal(900) * 3000).astype(np.int16)
        wavfile.write(str(tmp_path / "in" / f"{name}.wav"), 8000, sig)
    cli.main([str(tmp_path / "in"), str(tmp_path / "out"), "--model", str(model_path),
              "-N", "2", "--device", "cpu", "--seed", "1"])
    for name in ("a", "b"):
        for src in (0, 1):
            fs, data = wavfile.read(str(tmp_path / "out" / f"s{src}" / f"{name}.wav"))
            assert fs == 8000 and data.shape == (900,)


def test_scale_output_projects_the_mixture():
    sep = np.array([[[1.0, 0.0, 1.0], [0.0, 2.0, 0.0]]])
    mix = np.array([[[2.0, 1.0, 2.0]]])
    out = cli.scale_output(mix, sep)
    np.testing.assert_allclose(out[0, 0], [2.0, 0.0, 2.0], rtol=1e-6)
    np.testing.assert_allclose(out[0, 1], [0.0, 1.0, 0.0], rtol=1e-6)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DiffSepModel(PORT_TINY_CONFIG)
    (tmp_path / "in").mkdir()
    torch.save({}, tmp_path / "m.pt")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([str(tmp_path / "in"), str(tmp_path / "out"), "--model", str(tmp_path / "m.pt")])
    assert resolve_device("cpu") == torch.device("cpu")
    assert DiffSepModel(PORT_TINY_CONFIG, device="cpu").device.type == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    """On a non-CPU tensor a wrapper launches its kernel or raises; it
    never takes the plain version."""
    from diffsep_tpu_torch.ops import conv3x3, fir_resample2x

    x = torch.zeros(1, 4, 4, 2, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        conv3x3.conv3x3(x, torch.zeros(3, 3, 2, 2, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        fir_resample2x.fir_down2x(x, (0.125, 0.375, 0.375, 0.125))
