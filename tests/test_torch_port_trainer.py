"""The port's clippers, EMA and learning-rate schedules against the JAX
package's, in float32 on the CPU. Tolerances: 1e-6 relative for norms,
thresholds and learning rates (the same float32 formulas), 1e-5 for
clipped gradients and the EMA shadow after 25 updates."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsep_tpu.train import clippers as jax_clippers
from diffsep_tpu.train import ema as jax_ema
from diffsep_tpu.train import trainer as jax_trainer
from diffsep_tpu_torch.train import clippers, trainer
from diffsep_tpu_torch.train.ema import EMA
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)


def _grads(rng, n=4):
    return [rng.standard_normal((3, 5)).astype(np.float32) * s for s in np.linspace(0.5, 3.0, n)]


@pytest.mark.parametrize("kind", ["fixed", "autoclip"])
def test_clippers_match_jax(kind):
    rng = np.random.default_rng(0)
    if kind == "fixed":
        jc, pc = jax_clippers.FixedClipper(5.0), clippers.FixedClipper(5.0)
    else:  # a 4-slot ring, wrapped twice over 10 calls
        jc, pc = jax_clippers.AutoClipper(30.0, capacity=4), clippers.AutoClipper(30.0, capacity=4)
    js, ps = jc.init(), pc.init()
    for i in range(10):
        g = [x * (1 + i % 3) for x in _grads(rng)]
        jg, js, (jn, jt) = jc([jnp.asarray(x) for x in g], js)
        pg = [torch.from_numpy(x.copy()) for x in g]
        ps, (pn, pt) = pc(pg, ps)
        assert np.allclose(pn.numpy(), np.asarray(jn), rtol=1e-6)
        assert np.allclose(pt.numpy(), np.asarray(jt), rtol=1e-6)
        for a, b in zip(pg, jg):
            assert np.allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    if kind == "autoclip":
        assert ps.count == int(js.count) and np.allclose(ps.history.numpy(), np.asarray(js.history), rtol=1e-6)


def test_grad_norm_matches_jax():
    g = _grads(np.random.default_rng(1))
    assert np.isclose(clippers.grad_norm([torch.from_numpy(x) for x in g]).item(),
                      float(jax_clippers.grad_norm([jnp.asarray(x) for x in g])), rtol=1e-6)


def test_ema_matches_jax():
    rng = np.random.default_rng(2)
    p0 = _grads(rng)
    js, pe = jax_ema.init([jnp.asarray(x) for x in p0]), EMA([torch.from_numpy(x) for x in p0])
    for _ in range(25):
        p = _grads(rng)
        js = jax_ema.update(js, [jnp.asarray(x) for x in p], 0.99)
        pe.update([torch.from_numpy(x) for x in p], 0.99)
    assert pe.num_updates == int(js.num_updates) == 25
    for a, b in zip(pe.params, js.params):
        assert np.allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cfg", [
    dict(lr=1e-3), dict(lr=1e-3, lr_warmup=7), dict(lr=1e-3, lr_warmup=5, scheduler="exponential", scheduler_gamma=0.9),
    dict(lr=2e-4, scheduler="step", scheduler_step_size=4, scheduler_gamma=0.5),
    dict(lr=2e-4, lr_warmup=3, scheduler="cosine", scheduler_t_max=20),
], ids=["constant", "warmup", "exponential", "step", "cosine"])
def test_lr_schedules_match_jax(cfg):
    want = jax_trainer.make_lr_schedule(jax_trainer.OptimConfig(**cfg))
    got = trainer.make_lr_schedule(trainer.OptimConfig(**cfg))
    for step in range(30):
        assert np.isclose(got(step), float(want(jnp.asarray(step, jnp.float32))), rtol=1e-6)


