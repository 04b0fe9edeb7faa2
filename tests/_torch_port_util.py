"""Shared fixtures of the port's parity tests (tests/test_torch_port_*.py).

The JAX package is the reference: the same seeded numpy inputs, weights and
noise go through its functions and through their counterparts in
diffsep_tpu_torch, on the CPU, in float32.
"""
from __future__ import annotations

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
PORT_TINY_CONFIG = {
    "score_model": {
        "stft_args": TINY_STFT,
        "backbone_args": dict(TINY_BACKBONE, dtype="float32"),
    },
}


def jax_score_model(num_sources: int = 2) -> JaxScoreModel:
    backbone = JaxNCSNpp(
        num_channels_in=2 * num_sources + 2, num_channels_out=2 * num_sources,
        **TINY_BACKBONE,
    )
    return JaxScoreModel(backbone=backbone, num_sources=num_sources, **TINY_SCORE)


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
    check. The Fourier projection keeps its N(0, 16^2) init."""
    xt = jnp.zeros((1, model.num_sources, n_samples), jnp.float32)
    mix = jnp.zeros((1, 1, n_samples), jnp.float32)
    t = jnp.ones((1,), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), xt, t, mix)["params"]

    def fill(path, leaf):
        name = path[-1].key
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


def jax_pc_noise(key, shape, N: int, corrector_steps: int = 1):
    """The standard-normal draws diffsep_tpu's pc_sample makes from `key`,
    in the layout of diffsep_tpu_torch's `noise` argument: the prior from
    split(key) (pc.py), per step split(key, N) -> split(k) -> (kc, kp); the
    corrector draws normal(fold_in(kc, i)), the predictor normal(kp)."""
    key, prior_key = jax.random.split(key)
    noise = {"prior": np.array(jax.random.normal(prior_key, shape, jnp.float32))}
    corr, pred = [], []
    for k in jax.random.split(key, N):
        kc, kp = jax.random.split(k)
        corr.append([
            np.asarray(jax.random.normal(jax.random.fold_in(kc, i), shape, jnp.float32))
            for i in range(corrector_steps)
        ])
        pred.append(np.asarray(jax.random.normal(kp, shape, jnp.float32)))
    noise["corrector"] = np.asarray(corr, np.float32)
    noise["predictor"] = np.asarray(pred, np.float32)
    return {k: torch.from_numpy(v) for k, v in noise.items()}


def jax_loss_draws(key, shape, init_hack=False, order="random"):
    """The draws diffsep_tpu's training_loss makes from `key` for a target of
    `shape` (batch, n_src, samples), under the names of
    diffsep_tpu_torch.train.losses.Draws: the key splits of
    diffsep_tpu/train/losses.py replayed (training_loss :518, sample_prior
    :172-180, compute_score_loss_with_pit :253-266, _masked_init_step
    :366-405), each primitive drawn as it draws it. The time draw is the
    uniform in [0, 1) from which uniform(minval, maxval) and the varprop
    inverse CDF both start."""
    import math

    b, n, _ = shape
    draws = {}

    def time_z(kt, kz):
        draws["time"] = jax.random.uniform(kt, (b,))
        draws["z"] = jax.random.normal(kz, shape, jnp.float32)

    def sel(ks):
        draws["sel"] = jax.random.randint(ks, (b,), 0, math.factorial(n))

    if init_hack in (5, 6, 7):
        k_mask, k_init, k_reg, k_shuf = jax.random.split(key, 4)
        draws["mask"] = jax.random.uniform(k_mask, (b,))
        draws["z0"] = jax.random.normal(k_init, shape, jnp.float32)
        draws["shuffle"] = jax.random.uniform(k_shuf, (b, n))
        if init_hack == 6:
            kt, kz, ks = jax.random.split(k_reg, 3)
            sel(ks)
        else:
            kt, kz = jax.random.split(k_reg)
        time_z(kt, kz)
    elif order == "pit":
        kt, kz, ks = jax.random.split(key, 3)
        time_z(kt, kz)
        sel(ks)
    else:
        k_ord, key = jax.random.split(key)
        if order == "random":
            draws["shuffle"] = jax.random.uniform(k_ord, (b, n))
        kt, kz = jax.random.split(key)
        time_z(kt, kz)
        if init_hack == 4:
            draws["select"] = jax.random.uniform(jax.random.split(kz)[0], (b,))
    return {k: np.array(v) for k, v in draws.items()}


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
