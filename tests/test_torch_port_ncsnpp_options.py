"""The whole NCSN++ constructor of diffsep_tpu_torch against diffsep_tpu's,
on the CPU in float32.

Each option set builds the JAX ``NCSNpp`` and the port's at the size of
``tests/test_ncsnpp.py`` (SMALL: nf=16, three levels), fills the JAX params
with seeded unit-scale values, carries them across with
``state_dict_from_jax`` (a ``strict=True`` load, so the port builds exactly
the modules JAX builds; the names are also held to the JAX package's
converter's) and runs both on the same input. The sets are
``test_ncsnpp.py``'s, the four option sets A-D that ``chip_smoke.py``
drives at full width, and one per remaining option value. Tolerance: 1e-4
of the output's scale (measured 6e-7 to 3e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from diffsep_tpu.model import build_score_model as jax_build_score_model
from diffsep_tpu.models import NCSNpp as JaxNCSNpp
from diffsep_tpu.models.convert import flax_to_backbone_state_dict, flax_to_score_model_state_dict
from diffsep_tpu_torch.model import build_score_model
from diffsep_tpu_torch.models import NCSNpp, state_dict_from_jax

REL = 1e-4
SMALL = dict(nf=16, ch_mult=(1, 2, 2), num_res_blocks=1, attn_resolutions=(8,), image_size=32,
             num_channels_in=6, num_channels_out=4, fourier_scale=16.0)
# chip_smoke.py phase 12's option sets (backbone part)
SET_A = dict(fir=False, progressive="none", progressive_input="none", embedding_type="positional",
             scale_by_sigma=False)
SET_B = dict(progressive_input="residual")
SET_C = dict(resblock_type="ddpm", progressive="residual", progressive_input="input_skip",
             progressive_combine="cat", centered=True)
SET_D = dict(resblock_type="ddpm", fir=False, progressive="none", progressive_input="none",
             conditional=False, nonlinearity="elu", skip_rescale=False)
SETS = {
    # tests/test_ncsnpp.py's sets
    "default": {},
    "none_none": dict(progressive="none", progressive_input="none"),
    "nofir_none_none": dict(fir=False, progressive="none", progressive_input="none"),
    "ddpm_one_level": dict(resblock_type="ddpm", ch_mult=(1,), attn_resolutions=(32,)),
    "residual_residual": dict(progressive="residual", progressive_input="residual"),
    "cat": dict(progressive_combine="cat"),
    "A": SET_A, "B": SET_B, "C": SET_C, "D": SET_D,
    "ddpm": dict(resblock_type="ddpm"),
    "ddpm_nofir": dict(resblock_type="ddpm", fir=False),
    "ddpm_no_resample_conv": dict(resblock_type="ddpm", resamp_with_conv=False),
    "ddpm_nofir_no_resample_conv": dict(resblock_type="ddpm", fir=False, resamp_with_conv=False),
    "nofir_skip_pyramids": dict(fir=False),
    "nofir_residual_residual": dict(fir=False, progressive="residual", progressive_input="residual",
                                    skip_rescale=False),
    "nofir_cat": dict(fir=False, progressive_combine="cat"),
    "positional_unconditional": dict(embedding_type="positional", conditional=False),
    "relu": dict(nonlinearity="relu"),
    "lrelu": dict(nonlinearity="lrelu"),
    "elu": dict(nonlinearity="elu"),
    "silu_init_scale": dict(nonlinearity="silu", init_scale=0.1, fourier_scale=4.0),
    "dropout": dict(dropout=0.1),
}


def fill(shapes, rng):
    """Seeded unit-scale values in a param tree of these shapes (the Fourier
    projection keeps its N(0, 16^2) init)."""

    def leaf(path, x):
        name = path[-1].key
        if name == "W" and len(x.shape) == 1:
            return (16.0 * rng.standard_normal(x.shape)).astype(np.float32)
        if len(x.shape) >= 2:
            return (rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_backbone(overrides, rng):
    """(JAX model, filled params, input x, t) of one option set."""
    model = JaxNCSNpp(**{**SMALL, **overrides})
    x = rng.uniform(-1, 1, (2, 32, 16, 6)).astype(np.float32)
    t = np.asarray([0.4, 0.9], np.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))["params"]
    return model, fill(shapes, rng), x, t


def port_backbone(overrides, params):
    model = NCSNpp(**{**SMALL, **overrides})
    sd = state_dict_from_jax({"backbone": params})
    model.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()}, strict=True)
    return model.eval()


@pytest.mark.parametrize("name", sorted(SETS))
def test_backbone_matches_jax(name):
    rng = np.random.default_rng(sorted(SETS).index(name))
    jm, params, x, t = jax_backbone(SETS[name], rng)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    port = port_backbone(SETS[name], params)
    # the port's parameters are exactly JAX's, under the names of the JAX
    # package's converter (the reference checkpoints' names)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {
        k: v.shape for k, v in flax_to_backbone_state_dict(params).items()}
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (2, 32, 16, 4)
    np.testing.assert_allclose(got, want, atol=REL * np.abs(want).max())


def test_dropout_is_inert():
    """The JAX package never applies the backbone's dropout (no caller
    passes train=True): the port accepts the field and applies none, also
    in grad mode."""
    torch.manual_seed(0)
    a, b = NCSNpp(**SMALL), NCSNpp(**SMALL, dropout=0.5)
    a.reset_parameters(torch.Generator().manual_seed(1))
    b.load_state_dict(a.state_dict())
    x, t = torch.rand(1, 32, 16, 6), torch.tensor([0.5])
    assert torch.equal(a(x, t), b(x, t))


def _config(n_src, backbone, frontend):
    # n_fft 62: 32 frequency bins, SMALL's image_size
    return {"n_speakers": n_src, "score_model": {
        "stft_args": {"n_fft": 62, "hop_length": 16, **frontend.pop("stft_args", {})},
        "backbone_args": {"_target_": "diffsep_tpu_torch.models.NCSNpp", **backbone}, **frontend}}


FRONTENDS = {
    "A": (SET_A, dict(transform="log", spec_factor=0.15)),
    "B": (SET_B, dict(spec_trans_learnable=True, spec_abs_exponent=0.5, spec_factor=0.15)),
    "C": (SET_C, dict(transform="none", stft_args={"center": False})),
    "D": (SET_D, dict(spec_abs_exponent=1.0, spec_factor=0.3)),
}


@pytest.mark.parametrize("name", sorted(FRONTENDS))
def test_build_score_model_from_a_config(name):
    """model.build_score_model builds every option of a config node as the
    JAX package's build_score_model does: the same parameters, frontend
    and STFT."""
    backbone, frontend = FRONTENDS[name]
    backbone = dict(SMALL, **backbone)
    for k in ("num_channels_in", "num_channels_out"):
        backbone.pop(k)
    port = build_score_model(_config(2, backbone, dict(frontend)))
    jcfg = _config(2, dict(backbone, _target_="diffsep_tpu.models.NCSNpp"), dict(frontend))["score_model"]
    jax_model = jax_build_score_model(dict(jcfg, num_sources=2))
    for attr in ("transform", "center", "spec_trans_learnable", "n_fft", "hop_length"):
        assert getattr(port, attr) == getattr(jax_model, attr), attr
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, 800)), jnp.ones((1,)),
                            jnp.zeros((1, 1, 800)))["params"]
    want = flax_to_score_model_state_dict(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes))
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {k: v.shape for k, v in want.items()}


def test_unknown_backbone_still_raises():
    with pytest.raises(NotImplementedError, match="backbone"):
        build_score_model(_config(2, {"_target_": "somewhere.UNet"}, {}))
