"""Progressive distillation (diffsep_tpu_torch/train/distill.py and
cli/distill.py) against diffsep_tpu.train.distill, on the CPU in float32.

The JAX package is the oracle on a tiny NCSN++ (nf=8, two levels) with
seeded random weights, carried across by ``state_dict_from_jax``; its draws
are rebuilt from the same key (``jax_distill_draws``) and handed to the
port. Tolerances:
  * the closed forms (``invert_ddim_x0``, ``ddim_transport``,
    ``snr_channel_weights``) within 1e-6 of their scale, both SDEs; the SNR
    weights under PriorMixSDE's envelope within 1e-5 (its float32 cumsum,
    summed in another order: 2.6e-6 measured);
  * ``distill_loss`` within 5e-5 of its value and every parameter gradient
    within 1e-4 of the gradient norm, over weighting, on-policy inputs, SDE
    and time grid. The loss chains three to six evaluations of a network
    with unit-scale weights and weighs small-t rows by SNRs in the
    hundreds: float32 is not good to 1e-5 there. Against the port in
    float64, the port in float32 reads up to 1.2e-5 and the JAX package
    2.3e-5 (measured on four of these cases), the two against each other
    up to 2.6e-5;
  * one distillation step (clip, Adam, EMA) from a state carried across
    after one JAX step: the parameters' and the EMA's change within 1e-3 of
    its norm.
The rest are the port's counterparts of tests/test_distill.py, and the
CLI: a tiny ``cli.distill --device cpu`` run whose stage dirs
``cli.separate`` and ``cli.serve`` sample at ddim / none / N without flags.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import TINY_BACKBONE, TINY_SCORE, jax_distill_draws, random_params
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from diffsep_tpu.models import NCSNpp as JaxNCSNpp
from diffsep_tpu.models import ScoreModelNCSNpp as JaxScoreModel
from diffsep_tpu.sde.mixsde import MixSDE as JaxMixSDE
from diffsep_tpu.sde.mixsde import PriorMixSDE as JaxPriorMixSDE
from diffsep_tpu.train import distill as jax_distill
from diffsep_tpu_torch.models import NCSNpp, ScoreModelNCSNpp, state_dict_from_jax
from diffsep_tpu_torch.sampling.pc import make_timesteps, pc_sample
from diffsep_tpu_torch.sde import MixSDE, PriorMixSDE
from diffsep_tpu_torch.train import distill
from diffsep_tpu_torch.train.distill import (DistillConfig, data_prediction, ddim_transition, ddim_transport,
                                             distill_loss, invert_ddim_x0, snr_channel_weights)
from diffsep_tpu_torch.train.losses import Draws

BACKBONE = dict(TINY_BACKBONE, ch_mult=(1, 2))  # two levels
B, T = 4, 1000
CLOSED_TOL, ENVELOPE_TOL = 1e-6, 1e-5
LOSS_TOL, GRAD_TOL, STEP_TOL = 5e-5, 1e-4, 1e-3


def _sdes():
    return {"mix": (JaxMixSDE(N=8), MixSDE(N=8)),
            "priormix": (JaxPriorMixSDE(N=8, avg_len=32), PriorMixSDE(N=8, avg_len=32))}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _exact_delta_score(sde, x0):
    """The score of q(x_t | x0) for a fixed x0, -Sigma^-1 (x - M(t) x0), in
    the package of ``sde``."""

    def score_fn(x, t, cond):
        mean, L = sde.marginal_prob(x0, t, cond)
        return -sde.mult_std_inv(L, sde.mult_std_inv(L, x - mean))

    return score_fn


# --------------------------------------------------------------------------
# the closed forms, against the JAX package
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["mix", "priormix"])
def test_closed_forms_match_jax(name):
    """The transport runs on a smooth stand-in score, tanh(x + mix): the
    exact delta score of the fixed-point tests cancels x against Sigma
    score, which would measure the cancellation instead."""
    jsde, tsde = _sdes()[name]
    rng = np.random.default_rng(0)
    b, n = 3, 512
    x_t = rng.standard_normal((b, 2, n)).astype(np.float32)
    x_next = rng.standard_normal((b, 2, n)).astype(np.float32)
    mix = rng.standard_normal((b, 1, n)).astype(np.float32)
    t = np.array([1.0, 0.6, 0.08], np.float32)
    t_next = np.array([0.5, 0.03, 0.08], np.float32)  # the last: the identity transport
    jx = [jnp.asarray(v) for v in (x_t, t, t_next, x_next)]
    tx = [_t(v) for v in (x_t, t, t_next, x_next)]

    def close(got, want, tol=CLOSED_TOL):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * np.abs(want).max())

    close(invert_ddim_x0(tsde, *tx), jax_distill.invert_ddim_x0(jsde, *jx))
    for cond in (None, mix):
        # PriorMixSDE's envelope is a float32 cumsum that the two packages
        # sum in other orders (ROADMAP queue 3, PR 6): 2.6e-6 of scale here
        tol = ENVELOPE_TOL if cond is not None and name == "priormix" else CLOSED_TOL
        for g, w in zip(snr_channel_weights(tsde, tx[1], None if cond is None else _t(cond)),
                        jax_distill.snr_channel_weights(jsde, jx[1], None if cond is None else jnp.asarray(cond))):
            close(g, w, tol)
    for substeps in (1, 2):
        got = ddim_transport(tsde, lambda x, t, c: torch.tanh(x + c), tx[0], tx[1], tx[2], _t(mix), substeps)
        want = jax_distill.ddim_transport(jsde, lambda x, t, c: jnp.tanh(x + c), jx[0], jx[1], jx[2],
                                          jnp.asarray(mix), substeps)
        for g, w in zip(got, want):
            close(g, w)


# --------------------------------------------------------------------------
# distill_loss and its gradients on a tiny NCSN++, against the JAX package
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def nets():
    jm = JaxScoreModel(backbone=JaxNCSNpp(num_channels_in=6, num_channels_out=4, **BACKBONE), num_sources=2,
                       **TINY_SCORE)
    rng = np.random.default_rng(3)
    student, teacher = random_params(jm, rng), random_params(jm, rng)
    port = {}
    for name, params in (("student", student), ("teacher", teacher)):
        m = ScoreModelNCSNpp(NCSNpp(num_channels_in=6, num_channels_out=4, **BACKBONE), num_sources=2,
                             spec_factor=TINY_SCORE["spec_factor"],
                             spec_abs_exponent=TINY_SCORE["spec_abs_exponent"],
                             n_fft=TINY_SCORE["n_fft"], hop_length=TINY_SCORE["hop_length"]).eval()
        m.load_state_dict(state_dict_from_jax(params), strict=True)
        port[name] = m
    port["teacher"].requires_grad_(False)
    tgt = (0.3 * rng.standard_normal((B, 2, T))).astype(np.float32)
    mix = (tgt.sum(axis=1, keepdims=True) + 0.05 * rng.standard_normal((B, 1, T))).astype(np.float32)
    return dict(net=jax.jit(jm.apply), student=student, teacher=teacher, port=port, mix=mix, tgt=tgt)


def _grads_rel(grads: dict, jax_grads) -> float:
    """max |port - jax| over every parameter gradient, over the global norm
    of the JAX gradient."""
    want = state_dict_from_jax(jax_grads)
    norm = np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values()))
    return max(float((grads[k].double() - w.double()).abs().max()) for k, w in want.items()) / norm


CASES = list(itertools.product(["truncated_snr", "none"], [0.0, 1.0], ["mix", "priormix"], [None, "log"]))


@pytest.mark.parametrize("weighting,on_policy,sde_name,schedule", CASES)
def test_distill_loss_and_gradients_match_jax(nets, weighting, on_policy, sde_name, schedule):
    s = nets
    jsde, tsde = _sdes()[sde_name]
    kw = dict(n_student=4, t_eps=0.03, schedule=schedule, teacher_substeps=2, weighting=weighting,
              source_order="power", on_policy_frac=on_policy)
    jcfg, tcfg = jax_distill.DistillConfig(**kw), DistillConfig(**kw)
    key = jax.random.PRNGKey(3)  # grid steps 0, 3, 2, 2: the prior at T, the last step and others
    mix, tgt = jnp.asarray(s["mix"]), jnp.asarray(s["tgt"])

    def jax_loss(p):
        student = lambda x, t, m: s["net"]({"params": p}, x, t, m)  # noqa: E731
        teacher = lambda x, t, m: s["net"]({"params": s["teacher"]}, x, t, m)  # noqa: E731
        return jax_distill.distill_loss(key, jsde, student, teacher, mix, tgt, jcfg)

    want, jgrads = jax.value_and_grad(jax_loss)(s["student"])
    draws = jax_distill_draws(key, jcfg, s["tgt"].shape)
    assert draws["i"].min() == 0 and draws["i"].max() == 3
    student = s["port"]["student"]
    student.zero_grad(set_to_none=True)
    got = distill_loss(Draws(None, draws), tsde, student, s["port"]["teacher"], _t(s["mix"]), _t(s["tgt"]), tcfg)
    got.backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) for k, p in student.named_parameters()}
    student.zero_grad(set_to_none=True)
    assert abs(got.item() - float(want)) <= LOSS_TOL * abs(float(want)), (got.item(), float(want))
    assert _grads_rel(grads, jgrads) <= GRAD_TOL
    assert not any(p.grad is not None for p in s["port"]["teacher"].parameters())


def _rel(got: dict, want: dict, base_got: dict, base_want: dict) -> float:
    """|change of got - change of want| / |change of want| over all tensors,
    in L2 norm."""
    num = den = 0.0
    for k, w in want.items():
        g, w = got[k].detach().double() - base_got[k].double(), w.double() - base_want[k].double()
        num += float(((g - w) ** 2).sum())
        den += float((w ** 2).sum())
    return (num / den) ** 0.5


def test_distill_step_matches_jax(nets):
    """One step (clip, Adam, EMA) from a state carried across after one JAX
    step, on the JAX step's draws."""
    from diffsep_tpu.train import trainer as jax_trainer
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.models import train_state_from_jax

    s = nets
    rng = np.random.default_rng(4)
    batches = [((0.3 * rng.standard_normal((B, 1, T))).astype(np.float32),
                (0.2 * rng.standard_normal((B, 2, T))).astype(np.float32)) for _ in range(2)]
    kw = dict(n_student=4, t_eps=0.03, teacher_substeps=2, source_order="power")
    jopt = jax_trainer.OptimConfig(lr=1e-3, grad_clipper="fixed", clip_max_norm=5.0, ema_decay=0.999)
    tx, clipper = jax_trainer.make_optimizer(jopt), jax_trainer.make_clipper(jopt)
    base_key = jax.random.PRNGKey(6)
    step_fn = jax_distill.make_distill_step(lambda p, x, t, m: s["net"]({"params": p}, x, t, m), JaxMixSDE(),
                                            tx, clipper, jopt, base_key, jax_distill.DistillConfig(**kw))
    state = jax_trainer.init_train_state(s["student"], tx, clipper)
    state, _ = step_fn(state, s["teacher"], *(jnp.asarray(v) for v in batches[0]))

    model = DiffSepModel({"score_model": {"stft_args": {k: TINY_SCORE[k] for k in ("n_fft", "hop_length")},
                                          "backbone_args": dict(BACKBONE, dtype="float32")},
                          "optimizer": {"lr": 1e-3}}, device="cpu")
    pstate = train_state_from_jax(state, model)
    base_p = {"params": {k: p.detach().clone() for k, p in zip(pstate.names, pstate.params)},
              "ema": {k: e.clone() for k, e in zip(pstate.names, pstate.ema.params)}}
    base_j = {"params": state_dict_from_jax(state.params), "ema": state_dict_from_jax(state.ema.params)}
    draws = jax_distill_draws(jax.random.fold_in(base_key, int(state.step)), jax_distill.DistillConfig(**kw),
                              batches[1][1].shape)
    state, jm = step_fn(state, s["teacher"], *(jnp.asarray(v) for v in batches[1]))
    port_step = distill.make_distill_step(model.score_model, MixSDE(), model.optim_cfg, 0, DistillConfig(**kw))
    pm = port_step(pstate, s["port"]["teacher"], *(_t(v) for v in batches[1]), draws=draws)

    want = float(jm["distill/loss"])
    assert abs(pm["distill/loss"].item() - want) <= LOSS_TOL * abs(want)
    assert pstate.step == int(state.step) == 2 and pstate.ema.num_updates == int(state.ema.num_updates) == 2
    assert _rel(dict(zip(pstate.names, pstate.params)), state_dict_from_jax(state.params),
                base_p["params"], base_j["params"]) <= STEP_TOL
    assert _rel(dict(zip(pstate.names, pstate.ema.params)), state_dict_from_jax(state.ema.params),
                base_p["ema"], base_j["ema"]) <= STEP_TOL


# --------------------------------------------------------------------------
# the port's counterparts of tests/test_distill.py
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["mix", "priormix"])
def test_invert_ddim_x0_roundtrip(name):
    sde = _sdes()[name][1]
    rng = np.random.default_rng(1234)
    b, n = 3, 256
    x_t, x0 = (torch.from_numpy(rng.standard_normal((b, 2, n)).astype(np.float32)) for _ in range(2))
    for t_hi, t_lo in [(1.0, 0.5), (0.6, 0.03), (0.08, 0.03)]:
        t, t_next = torch.full((b,), t_hi), torch.full((b,), t_lo)
        rec = invert_ddim_x0(sde, x_t, t, t_next, ddim_transition(sde, x_t, t, t_next, x0))
        torch.testing.assert_close(rec, x0, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["mix", "priormix"])
def test_exact_score_recovers_x0(name):
    """With the exact delta-data score the data prediction is x0 at every t,
    and the teacher's transport inverted is x0 for any substep count."""
    sde = _sdes()[name][1]
    rng = np.random.default_rng(1234)
    b, n = 2, 512
    x0 = torch.from_numpy((0.1 * rng.standard_normal((b, 2, n))).astype(np.float32))
    mix = x0.sum(dim=1, keepdim=True)
    score_fn = _exact_delta_score(sde, x0)
    for t_hi, t_lo in [(1.0, 0.52), (0.52, 0.03)]:
        t, t_next = torch.full((b,), t_hi), torch.full((b,), t_lo)
        mean, L = sde.marginal_prob(x0, t, mix)
        x_t = mean + sde.mult_std(L, torch.from_numpy(rng.standard_normal((b, 2, n)).astype(np.float32)))
        torch.testing.assert_close(data_prediction(sde, score_fn, x_t, t, mix), x0, rtol=5e-4, atol=5e-5)
        for substeps in (1, 2, 4):
            x_end, _ = ddim_transport(sde, score_fn, x_t, t, t_next, mix, substeps)
            torch.testing.assert_close(invert_ddim_x0(sde, x_t, t, t_next, x_end), x0, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("on_policy", [0.0, 1.0])
def test_distill_loss_zero_at_fixed_point(on_policy):
    """Student = teacher = the exact score: the loss vanishes, the last step,
    the prior at T and the on-policy inputs included."""
    sde = MixSDE(N=8)
    rng = np.random.default_rng(1234)
    x0 = torch.from_numpy((0.1 * rng.standard_normal((16, 2, 256))).astype(np.float32))
    score_fn = _exact_delta_score(sde, x0)
    cfg = DistillConfig(n_student=4, t_eps=0.03, teacher_substeps=2, source_order="none", weighting="none",
                        on_policy_frac=on_policy)
    loss = distill_loss(Draws(torch.Generator().manual_seed(3)), sde, score_fn, score_fn, x0.sum(dim=1, keepdim=True),
                        x0, cfg)
    assert loss.item() < 1e-6


def test_snr_weights_floor_monotone_and_envelope():
    t = torch.linspace(0.03, 1.0, 16)
    w1, w2 = snr_channel_weights(MixSDE(N=8), t)
    assert (w1 >= 1.0).all() and (w2 >= 1.0).all()
    assert (torch.diff(w1.flatten()) <= 1e-6).all() and (torch.diff(w2.flatten()) <= 1e-6).all()
    # PriorMixSDE: the weights scale as 1 / env^2 above the floor (a 4x
    # hotter mixture quarters them); MixSDE ignores the mixture
    sde = PriorMixSDE(N=8, avg_len=8)
    mix = torch.from_numpy(np.random.default_rng(1234).standard_normal((3, 1, 64)).astype(np.float32)) * 0.05
    t = torch.full((3,), 0.1)
    (w1, w2), (h1, h2) = snr_channel_weights(sde, t, mix), snr_channel_weights(sde, t, 2.0 * mix)
    for w, h in ((w1, h1), (w2, h2)):
        above = w > 4.0
        assert above.any()
        torch.testing.assert_close(h[above], w[above] / 4.0, rtol=2e-4, atol=0)
    assert all(torch.equal(a, b) for a, b in zip(snr_channel_weights(MixSDE(N=8), t),
                                                 snr_channel_weights(MixSDE(N=8), t, mix)))


def test_distill_ema_gates_on_applied_steps():
    """Under accumulation the EMA moves only on applied optimizer steps."""
    from diffsep_tpu_torch.train.trainer import OptimConfig, init_train_state

    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(2, 2))

        def forward(self, x, t, mix):
            return torch.tanh(torch.einsum("cd,bdt->bct", self.w, x))

    student = Toy()
    teacher = distill.frozen_copy(student)
    optim = OptimConfig(accumulate_grad_batches=2, grad_clipper="none")
    state = init_train_state(student, optim)
    step = distill.make_distill_step(student, MixSDE(N=8), optim, 0,
                                     DistillConfig(n_student=2, source_order="none", weighting="none"))
    x0 = torch.from_numpy(np.random.default_rng(1234).standard_normal((8, 2, 32)).astype(np.float32))
    mix = x0.sum(dim=1, keepdim=True)
    step(state, teacher, mix, x0)
    assert state.ema.num_updates == 0 and torch.equal(state.ema.params[0], torch.ones(2, 2))
    step(state, teacher, mix, x0)
    assert state.ema.num_updates == 1 and not torch.equal(state.ema.params[0], torch.ones(2, 2))
    assert not teacher.w.requires_grad and torch.equal(teacher.w, torch.ones(2, 2))


@pytest.mark.parametrize("schedule", [None, "log"])
def test_serving_grid_matches_pc_sample(schedule):
    """The distillation grid is pc_sample's ddim grid: data_prediction and
    ddim_transition unrolled over make_timesteps from pc_sample's prior
    draw give pc_sample(ddim, none, N)."""
    sde = MixSDE(N=8)
    rng = np.random.default_rng(1234)
    b, n, N, eps = 2, 256, 4, 0.03
    x0 = torch.from_numpy((0.1 * rng.standard_normal((b, 2, n))).astype(np.float32))
    mix = x0.sum(dim=1, keepdim=True)
    score_fn = _exact_delta_score(sde, x0)
    z = torch.from_numpy(rng.standard_normal((b, 2, n)).astype(np.float32))
    got, nfe = pc_sample(sde, score_fn, mix, "ddim", "none", N=N, eps=eps, schedule=schedule, noise={"prior": z})
    assert nfe == N
    x = sde.copy(N=N).prior_sampling(mix, z=z)
    ts, _ = make_timesteps(sde.T, eps, N, schedule)
    for i in range(N):
        t, t_next = torch.full((b,), float(ts[i])), torch.full((b,), float(ts[min(i + 1, N - 1)]))
        x0_hat = data_prediction(sde, score_fn, x, t, mix)
        x = ddim_transition(sde, x, t, t_next, x0_hat)
    torch.testing.assert_close(got, x0_hat, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def tiny_model():
    from diffsep_tpu_torch.model import DiffSepModel

    model = DiffSepModel({"score_model": {"stft_args": {k: TINY_SCORE[k] for k in ("n_fft", "hop_length")},
                                          "backbone_args": dict(BACKBONE, dtype="float32")},
                          "optimizer": {"lr": 1e-3}}, device="cpu")
    rng = np.random.default_rng(1234)
    tgt = torch.from_numpy((0.1 * rng.standard_normal((2, 2, 2048))).astype(np.float32))
    return model, {k: v.clone() for k, v in model.score_model.state_dict().items()}, tgt.sum(dim=1, keepdim=True), tgt


def test_progressive_distill_halving(tiny_model):
    """Each stage's EMA state dict loads and serves at its N through the
    stock ddim sampler; the model holds the last stage's."""
    model, start, mix, tgt = tiny_model
    model.score_model.load_state_dict(start)
    out = distill.progressive_distill(model, lambda step: (mix, tgt), stages=(2, 1), steps_per_stage=2, seed=11)
    assert set(out) == {2, 1}
    assert all(torch.equal(v, out[1][k]) for k, v in model.score_model.state_dict().items())
    for n, sd in out.items():
        assert set(sd) == set(start) and any(not torch.equal(sd[k], start[k]) for k in start)
        model.score_model.load_state_dict(sd)
        est, nfe = model.separate(mix, generator=torch.Generator().manual_seed(0), predictor_name="ddim",
                                  corrector_name="none", N=n, schedule="log")
        assert est.shape == tgt.shape and nfe == n and torch.isfinite(est).all()


def test_progressive_distill_stage_cache_resumes(tiny_model, tmp_path):
    """A rerun loads each finished stage from the cache instead of training
    (its batch_fn would raise) and returns the same weights."""
    model, start, mix, tgt = tiny_model
    cache = tmp_path / "stages"
    model.score_model.load_state_dict(start)
    out1 = distill.progressive_distill(model, lambda step: (mix, tgt), stages=(2, 1), steps_per_stage=2, seed=11,
                                       stage_cache_dir=str(cache))
    assert sorted(p.name for p in cache.iterdir()) == ["stage0_N2.pt", "stage1_N1.pt"]

    def boom(step):
        raise AssertionError("a cached stage must not train again")

    model.score_model.load_state_dict(start)
    out2 = distill.progressive_distill(model, boom, stages=(2, 1), steps_per_stage=2, seed=11,
                                       stage_cache_dir=str(cache))
    for n in (2, 1):
        assert all(torch.equal(out1[n][k], out2[n][k]) for k in out1[n])


def test_an_interrupted_stage_cache_write_leaves_no_file(tiny_model, tmp_path, monkeypatch):
    """A write that dies half way leaves nothing a relaunch would load: no
    file under the stage's name, no temporary one."""
    from diffsep_tpu_torch.train import checkpoints

    def torn_save(obj, f):
        with open(f, "wb") as fh:
            fh.write(b"half a checkpoint")
        raise OSError("no space left on device")

    model, start, mix, tgt = tiny_model
    model.score_model.load_state_dict(start)
    monkeypatch.setattr(checkpoints.torch, "save", torn_save)
    cache = tmp_path / "stages"
    with pytest.raises(OSError, match="no space"):
        distill.progressive_distill(model, lambda step: (mix, tgt), stages=(2,), steps_per_stage=1,
                                    stage_cache_dir=str(cache))
    assert list(cache.iterdir()) == []


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------
def test_distill_cli_stages_serve_at_their_n(tmp_path):
    """cli.distill writes a run dir per stage whose config pins ddim / none /
    N (and the schedule); cli.separate samples it there without flags, as
    with the flags given, and cli.serve's engine takes the same sampler."""
    import argparse

    import yaml

    from diffsep_tpu_torch.cli import distill as distill_cli
    from diffsep_tpu_torch.cli import separate as separate_cli
    from diffsep_tpu_torch.cli import serve as serve_cli
    from diffsep_tpu_torch.cli import train as train_cli
    from diffsep_tpu_torch.data.audio_io import load_wav, save_wav
    from diffsep_tpu_torch.data.synthetic import write_wsj0_mix
    from test_torch_port_serve import TINY_TRAIN

    data = write_wsj0_mix(tmp_path / "wsj0_mix", {"train": 2, "val": 2}, seconds=0.5, seed=0)
    train_cli.main(["experiment=icassp-separation", f"path.datasets.wsj0_mix={data}",
                    f"path.exp_root={tmp_path / 'exp'}", *TINY_TRAIN])
    (run,) = [p for p in (tmp_path / "exp" / "default").iterdir() if p.is_dir()]
    out = tmp_path / "distilled"
    distill_cli.main([str(run), "--stages", "4,2", "--steps", "1", "--schedule", "log", "--out", str(out),
                      "--device", "cpu", "--log-every", "1"])
    for n in (4, 2):
        cfg = yaml.safe_load((out / f"N{n}" / "hparams.yaml").read_text())["config"]
        assert cfg["model"]["sampler"] == {"predictor_name": "ddim", "corrector_name": "none", "N": n,
                                           "schedule": "log"}
        assert (out / f"N{n}" / "checkpoints" / "latest.pt").exists()

    wavs = tmp_path / "in"
    for i, n in enumerate((3000, 4000)):
        save_wav(wavs / f"m{i}.wav", (0.1 * np.random.default_rng(i).standard_normal((1, n))).astype(np.float32),
                 8000)
    stage = str(out / "N2")
    separate_cli.main([str(wavs), str(tmp_path / "pinned"), "--model", stage, "--device", "cpu"])
    separate_cli.main([str(wavs), str(tmp_path / "flags"), "--model", stage, "--device", "cpu", "--predictor", "ddim",
                       "--corrector", "none", "-N", "2", "-s", "log"])
    for f in sorted((tmp_path / "flags").rglob("*.wav")):
        got = load_wav(tmp_path / "pinned" / f.relative_to(tmp_path / "flags"))[0]
        np.testing.assert_array_equal(got, load_wav(f)[0])
    args = argparse.Namespace(model=out / "N2", device="cpu", N=None, snr=None, corrector_steps=None, predictor=None,
                              corrector=None, batch=2, bucket_s=1.0, seed=0)
    engine = serve_cli._engine_from_args(args)
    assert (engine.predictor, engine.corrector) == ("ddim", "none")
    assert engine.sampler_kwargs == {"N": 2, "schedule": "log"}
