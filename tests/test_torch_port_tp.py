"""Tensor-parallel separation in the port (parallel/tensor_parallel.py) on
the CPU, over two gloo ranks, in float32.

The JAX package is the oracle: the tiny model's seeded weights go through
the JAX ``make_tp_separate`` on a virtual CPU mesh and through the port's on
two ranks, in the layouts 1 x 2 (one utterance over both ranks) and 2 x 1
(the rows split), with the JAX sampler's own draws handed to the port
(reverse_diffusion + ald2, N=2). Each must agree within 1e-5 of scale with
the replicated port separation of the same draws, and within 5e-4 of scale
with the JAX tensor-parallel estimate: on these unit-scale weights the two
packages' replicated separations already read 1.2e-4 of scale apart (the
score network's float32 sums in other orders, amplified by the sampler),
and the JAX package's own tensor-parallel estimate reads 2.5e-5 from its
replicated one, so 1e-5 against JAX would hold the oracle's reassociation,
not the port's layout. Also:
  * the split rule equals the JAX package's ``tp_shardings`` on the same
    weights (conv and dense kernels on their output axis, biases with
    them);
  * at tp = 2 every split weight a rank holds has half its output
    channels, the rest whole;
  * with a seeded generator the ranks of one tp group sample the same
    utterance, equal to ``model.separate`` with that seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_port_util import JAX_TINY_OVERRIDES, jax_pc_noise, random_params
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from diffsep_tpu.config import compose as jax_compose
from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel
from diffsep_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from diffsep_tpu.parallel import make_tp_separate as jax_make_tp_separate
from diffsep_tpu.parallel import tp_shardings as jax_tp_shardings
from diffsep_tpu_torch.config import compose
from diffsep_tpu_torch.model import DiffSepModel
from diffsep_tpu_torch.models import layers, state_dict_from_jax
from diffsep_tpu_torch.parallel import tensor_parallel as tpm
from test_torch_port_ddp import TESTS, _free_port, _run_ranks

TOL, JAX_TOL = 1e-5, 5e-4
LAYOUTS = [(1, 2), (2, 1)]
SAMPLER = dict(N=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    jcfg = jax_compose(JAX_TINY_OVERRIDES)
    jm = JaxDiffSepModel(jcfg)
    params = random_params(jm.score_model, np.random.default_rng(21))
    rng = np.random.default_rng(22)
    mix = (0.3 * rng.standard_normal((3, 1, 800))).astype(np.float32)  # 2 x 1 pads it to 4 rows
    key = jax.random.PRNGKey(9)
    jax_est = {}
    for dp, tp in LAYOUTS:
        run = jax_make_tp_separate(jm, params, jax_make_mesh_2d(dp, tp), **SAMPLER)
        jax_est[(dp, tp)] = np.asarray(run(key, mix)[0])
    noise = jax_pc_noise(key, (3, 2, 800), SAMPLER["N"])
    config = compose(JAX_TINY_OVERRIDES)
    model = DiffSepModel(config, device="cpu")
    model.score_model.load_state_dict(state_dict_from_jax(params), strict=True)
    replicated, _ = model.separate(mix, noise=noise, **SAMPLER)
    seeded, _ = model.separate(mix, generator=torch.Generator().manual_seed(7), **SAMPLER)
    payload = {"config": config, "model": model.score_model.state_dict(), "mix": mix, "noise": noise,
               "sampler": SAMPLER, "layouts": LAYOUTS}
    torch.save(payload, tmp / "payload.pt")
    port = _free_port()
    _run_ranks(lambda r: [str(TESTS / "_torch_port_tp_worker.py"), str(tmp / "payload.pt"), str(tmp), str(r), "2",
                          str(port)])
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return {"ranks": ranks, "jax": jax_est, "replicated": replicated, "seeded": seeded, "params": params,
            "whole": {k: tuple(v.shape) for k, v in payload["model"].items()}, "jax_model": jm}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tp_separation_matches_replicated_and_jax(runs, layout):
    want = runs["replicated"]
    scale = float(want.abs().max())
    for r in runs["ranks"]:
        got = r[layout]["est"]
        assert got.shape == want.shape == (3, 2, 800) and r[layout]["nfe"] == 4
        assert float((got - want).abs().max()) <= TOL * scale
        assert float((got - torch.tensor(runs["jax"][layout])).abs().max()) <= JAX_TOL * scale


def test_tp_generator_matches_separate_with_the_same_seed(runs):
    # 1 x 2: both ranks sample the utterance model.separate samples
    for r in runs["ranks"]:
        got = r[(1, 2)]["seeded"]
        assert float((got - runs["seeded"]).abs().max()) <= TOL * float(runs["seeded"].abs().max())
    # 2 x 1: the rows split, the draws those of the whole batch: both
    # ranks return the same whole batch
    a, b = (r[(2, 1)]["seeded"] for r in runs["ranks"])
    assert torch.equal(a, b) and a.shape == (3, 2, 800)


def test_tp_split_rule_matches_jax(runs):
    """The port splits exactly the conv and dense kernels (and their
    biases) that JAX's tp_shardings splits on their output axis; of JAX's
    other splits (rank-1 vectors whose activations GSPMD keeps sharded) it
    keeps GroupNorm's and the Fourier projection's whole."""
    params = runs["params"]
    specs = jax_tp_shardings(params, jax_make_mesh_2d(1, 2))
    flags = jax.tree_util.tree_map(lambda x, s: np.full(np.shape(x), 0.0 if s.spec == P() else 1.0, np.float32),
                                   params, specs)
    jax_split = {k for k, v in state_dict_from_jax(flags).items() if v.numel() and float(v.max()) == 1.0}
    model = DiffSepModel(compose(JAX_TINY_OVERRIDES), device="cpu")
    split = {k for k, v in tpm.tp_shardings(model.score_model, 2).items() if v is not None}
    assert len(split) > 10 and split <= jax_split
    whole = {f"{name}.{p}" for name, m in model.score_model.named_modules()
             if isinstance(m, (layers.GroupNorm, layers.GaussianFourierProjection)) for p, _ in m.named_parameters()}
    assert jax_split - split <= whole


def test_tp_ranks_hold_half_of_each_split_weight(runs):
    whole = runs["whole"]
    model = DiffSepModel(compose(JAX_TINY_OVERRIDES), device="cpu")
    specs = tpm.tp_shardings(model.score_model, 2)
    assert sum(v is not None for v in specs.values()) > 10
    for r in runs["ranks"]:
        held = r[(1, 2)]["shapes"]
        for name, axis in specs.items():
            want = list(whole[name])
            if axis is not None:
                want[axis] //= 2
            assert held[name] == tuple(want), name
        # 2 x 1 splits nothing
        assert r[(2, 1)]["shapes"] == whole
    assert [r[(1, 2)]["mesh"] for r in runs["ranks"]] == [(0, 0), (0, 1)]
    assert [r[(2, 1)]["mesh"] for r in runs["ranks"]] == [(0, 0), (1, 0)]


def test_mesh_without_a_group_is_one_by_one():
    tm = tpm.make_mesh_2d(1, 1)
    assert (tm.dp, tm.tp, tm.tp_group, tm.dp_group) == (1, 1, None, None)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tpm.make_mesh_2d(1, 2)
