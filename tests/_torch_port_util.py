"""Shared fixtures of the port's parity tests (tests/test_torch_port_*.py).

The JAX package is the reference: the same seeded numpy inputs, weights and
noise go through its functions and through their counterparts in
diffsep_tpu_torch, on the CPU, in float32.
"""
from __future__ import annotations

import importlib.util
import os
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsep_tpu.models import NCSNpp as JaxNCSNpp
from diffsep_tpu.models import ScoreModelNCSNpp as JaxScoreModel
from diffsep_tpu_torch.models import NCSNpp, ScoreModelNCSNpp, state_dict_from_jax

# three levels (64, 32, 16 frequency bins) so that attention at 16 fires in
# the down path, the up path and the bottleneck
TINY_BACKBONE = dict(
    nf=8, ch_mult=(1, 2, 2), num_res_blocks=1, attn_resolutions=(16,), image_size=64,
)
TINY_STFT = dict(n_fft=126, hop_length=32)
TINY_SCORE = dict(spec_factor=0.15, spec_abs_exponent=0.5, **TINY_STFT)

# the same tiny model as a DiffSepModel config: the JAX package's overrides
# and the port's config dict
JAX_TINY_OVERRIDES = [
    "experiment=icassp-separation",
    "model.score_model.backbone_args.dtype=float32",
    "model.score_model.backbone_args.nf=8",
    "model.score_model.backbone_args.ch_mult=[1,2,2]",
    "model.score_model.backbone_args.num_res_blocks=1",
    "model.score_model.backbone_args.attn_resolutions=[16]",
    "model.score_model.backbone_args.image_size=64",
    "model.score_model.stft_args.n_fft=126",
    "model.score_model.stft_args.hop_length=32",
]
SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


def without_targets(node):
    """A composed config node without its ``_target_`` keys (class paths,
    which name each package's own classes), lists for tuples."""
    if isinstance(node, dict):
        return {k: without_targets(v) for k, v in node.items() if k != "_target_"}
    return list(node) if isinstance(node, (list, tuple)) else node


def load_script(name: str):
    """``scripts/<name>.py`` as a module, loaded by path. The JAX package's
    demo scripts enable JAX's compile cache when imported: it stays off
    (DIFFSEP_CACHE_DIR=0), so that loading one writes nothing."""
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    with mock.patch.dict(os.environ, {"DIFFSEP_CACHE_DIR": "0"}):
        spec.loader.exec_module(mod)
    return mod


# the JAX package's sampler and loss draws in the port's layout
_draws = load_script("jax_draws")
jax_pc_noise, jax_loss_draws, jax_distill_draws = (
    _draws.jax_pc_noise, _draws.jax_loss_draws, _draws.jax_distill_draws)


PORT_TINY_CONFIG = {
    "score_model": {
        "stft_args": TINY_STFT,
        "backbone_args": dict(TINY_BACKBONE, dtype="float32"),
    },
}


def jax_score_model(num_sources: int = 2, backbone=None, **score) -> JaxScoreModel:
    """The tiny JAX score model; ``backbone`` and ``score`` override its
    backbone's and frontend's fields."""
    net = JaxNCSNpp(
        num_channels_in=2 * num_sources + 2, num_channels_out=2 * num_sources,
        **{**TINY_BACKBONE, **(backbone or {})},
    )
    return JaxScoreModel(backbone=net, num_sources=num_sources, **{**TINY_SCORE, **score})


def port_score_model(num_sources: int = 2) -> ScoreModelNCSNpp:
    backbone = NCSNpp(
        num_channels_in=2 * num_sources + 2, num_channels_out=2 * num_sources,
        **TINY_BACKBONE,
    )
    return ScoreModelNCSNpp(backbone, num_sources=num_sources, **TINY_SCORE).eval()


def random_params(model, rng: np.random.Generator, n_samples: int = 1000):
    """A param tree of the JAX model's structure filled with seeded values of
    unit scale. The initializers' init_scale=0 layers would leave whole
    branches at ~1e-10; random values make every layer count in a parity
    check. The Fourier projection keeps its N(0, 16^2) init, and the
    learnable transform constants stay within 10% of their initial values."""
    xt = jnp.zeros((1, model.num_sources, n_samples), jnp.float32)
    mix = jnp.zeros((1, 1, n_samples), jnp.float32)
    t = jnp.ones((1,), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), xt, t, mix)["params"]

    def fill(path, leaf):
        name = path[-1].key
        if name in ("spec_abs_exponent", "spec_factor"):
            return np.float32(getattr(model, name) * (1.0 + 0.1 * rng.standard_normal()))
        if name == "W" and len(leaf.shape) == 1:
            return (16.0 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if len(leaf.shape) >= 2:
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def load_port_weights(module: torch.nn.Module, params) -> None:
    module.load_state_dict(state_dict_from_jax(params), strict=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a module's tests (imported by a test module,
    it applies to that module): the models are tiny, and the test workers
    run in parallel, where each worker's full thread pool would contend for
    the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
