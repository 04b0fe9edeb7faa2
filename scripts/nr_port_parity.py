#!/usr/bin/env python3
"""The enhancement demo (scripts/train_demo_nr.py) against its PyTorch port
(scripts/torch_port_train_demo_nr.py) at full width on the CPU: the bisect of
a missed quality bar. It imports both packages, so it runs where JAX does,
never on the card.

    JAX_PLATFORMS=cpu python scripts/nr_port_parity.py train [steps] [--work-dir DIR] [--out PATH]
    JAX_PLATFORMS=cpu python scripts/nr_port_parity.py compare JAX_SIDE.json PORT_SIDE.json [--out PATH]
    JAX_PLATFORMS=cpu python scripts/nr_port_parity.py eval TEACHER.pt [--dtype float32]

``train``: the JAX script's loop and the port's, nf 32 in float32 at batch
16 x 1 s (bf16 on the CPU is emulated and slow), from the JAX init of seed 0
carried across, the port's steps taking the JAX step's draws, each loop in
a process of its own, both at once (``side``; about 12 s a JAX step and 7 s
a port step on 8 cores, each alone). Each side writes its per-step losses
to DIR (the JAX side every 10 steps, so that a cut run still compares) and,
at the end, its weights and EMA weights. ``compare``: over the steps both
sides have taken, the largest relative gap per step and per 10-step mean,
and, once both have finished, the relative gap of the weights and of the
EMA weights. ``side port --perturb 1e-6`` is a control: the port from an
init perturbed at the size of rounding, compared with the unperturbed port
side, shows how fast such a difference grows without any fault. ``eval``: a port weights file (the EMA teacher that
``torch_port_train_demo_nr.py --save-ckpt`` writes) scored by the JAX
script's evaluation code and by the port's on the 8 held-out clips, PC N=30
and ddim N=4 on the log grid, the port with the JAX sampler's draws and with
its own generator.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for _p in (str(HERE.parent), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_port_train_demo_nr as nr  # noqa: E402
from jax_draws import jax_loss_draws, jax_pc_noise  # noqa: E402
from diffsep_tpu.config import compose as jax_compose  # noqa: E402
from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel  # noqa: E402
from diffsep_tpu.models.convert import convert_backbone_state_dict  # noqa: E402
from diffsep_tpu.models.losses import PESQ as JaxPESQ  # noqa: E402
from diffsep_tpu.models.losses import SISDRLoss as JaxSISDRLoss  # noqa: E402
from diffsep_tpu_torch.models import state_dict_from_jax  # noqa: E402
from diffsep_tpu_torch.train.checkpoints import load_payload  # noqa: E402


def jax_init(seed):
    """The JAX script's model (float32) and its init from ``PRNGKey(seed)`` on
    the one batch it draws first, with the data stream after that batch."""
    jm = JaxDiffSepModel(jax_compose(nr.nr_overrides("float32", False)))
    rng = np.random.default_rng(seed)
    mix, tgt = nr.make_batch(rng, nr.BATCH, nr.SAMPLES)
    return jm, jm.init_state(jax.random.PRNGKey(seed), jnp.asarray(mix), jnp.asarray(tgt)), rng


def write_side(out, side, seed, steps, losses, weights=None, perturb=0.0):
    Path(out).write_text(json.dumps({"side": side, "perturb": perturb, "seed": seed, "steps": steps,
                                     "done": len(losses), "losses": losses}))
    if weights is not None:
        torch.save(weights, Path(out).with_suffix(".pt"))


def train_side(side, steps, seed, out, perturb=0.0):
    """One loop from the JAX init of ``seed``: the JAX script's (``jax``) or the
    port's (``port``, the weights carried across, each step taking the JAX
    step's draws). Writes its per-step losses to ``out`` (every 10 steps on
    the JAX side) and, at the end, its weights and EMA weights in the port's
    layout beside it (``.pt``). ``perturb`` scales each weight of the port's
    init by 1 + perturb x N(0, 1): a control run, whose gap to the
    unperturbed port run shows how fast rounding-sized differences grow."""
    jm, state, rng = jax_init(seed)
    base = jax.random.PRNGKey(1000 * seed + 1)
    if side == "jax":
        step_fn = jax.jit(jm.make_train_step(base), donate_argnums=(0,))
        losses, t0 = [], time.perf_counter()
        for i in range(steps):
            mix, tgt = nr.make_batch(rng, nr.BATCH, nr.SAMPLES)
            state, metrics = step_fn(state, jnp.asarray(mix), jnp.asarray(tgt))
            losses.append(float(metrics["train/score_loss"]))
            if (i + 1) % 10 == 0:
                print(f"jax step {i + 1}: loss {losses[-1]:.4f} ({time.perf_counter() - t0:.0f} s)", flush=True)
                write_side(out, side, seed, steps, losses, perturb=perturb)
        weights = {"params": state_dict_from_jax(state.params), "ema": state_dict_from_jax(state.ema.params)}
    else:
        pm = nr.build_model("float32", False, "cpu", seed)
        pm.score_model.load_state_dict(state_dict_from_jax(state.params), strict=True)
        if perturb:
            g = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                for p in pm.score_model.parameters():
                    p.mul_(1 + perturb * torch.randn(p.shape, generator=g))
        shape = (nr.BATCH, 2, nr.SAMPLES)
        run = nr.train(pm, seed, steps, np.random.default_rng(seed), log=lambda m: print(f"port {m}", flush=True),
                       draws=lambda i: jax_loss_draws(jax.random.fold_in(base, i), shape, 4, "None"))
        losses = [float(x) for x in run["losses"]]
        names = run["state"].names
        weights = {"params": {k: p.detach().clone() for k, p in zip(names, run["state"].params)},
                   "ema": {k: p.detach().clone() for k, p in zip(names, run["state"].ema.params)}}
    write_side(out, side, seed, steps, losses, weights, perturb)


def compare(jax_out, port_out):
    """The two sides' losses over the steps both have taken: the largest
    per-step relative gap (of the second side to the first), the means of
    every 10 steps, and, where both sides have finished, the relative gap
    of the weights and of the EMA weights."""
    j, p = (json.loads(Path(o).read_text()) for o in (jax_out, port_out))
    n = min(j["done"], p["done"])
    jl, pl = np.asarray(j["losses"][:n]), np.asarray(p["losses"][:n])
    gap = np.abs(pl - jl) / np.abs(jl)
    windows = [[float(jl[i:i + 10].mean()), float(pl[i:i + 10].mean())] for i in range(0, n - 9, 10)]
    sides = [f"{d['side']}, init x (1 + {d['perturb']:g} N(0, 1))" if d.get("perturb") else d["side"] for d in (j, p)]
    out = {"steps": n, "seed": j["seed"], "sides": sides, "losses": [jl.tolist(), pl.tolist()],
           "max_rel_gap": float(gap.max()), "max_rel_gap_step": int(gap.argmax()) + 1,
           "max_rel_gap_every10": max((abs(b - a) / abs(a) for a, b in windows), default=None),
           "mean_every10": windows}
    jw, pw = (Path(o).with_suffix(".pt") for o in (jax_out, port_out))
    if j["done"] == p["done"] and jw.exists() and pw.exists():
        jw, pw = torch.load(jw), torch.load(pw)
        for kind in ("params", "ema"):
            a, b = jw[kind], pw[kind]
            assert a.keys() == b.keys()
            # the whole tree's relative gap, and the largest of the tensors
            # that are not ~0 (the attention NIN biases stay near 1e-13:
            # Adam's steps there follow the sign of rounding noise)
            out[f"rel_gap_{kind}"] = float(
                sum((b[k] - v).pow(2).sum() for k, v in a.items()).sqrt()
                / sum(v.pow(2).sum() for v in a.values()).sqrt())
            out[f"max_rel_gap_{kind}_tensor"] = max(
                float((b[k] - v).norm() / v.norm()) for k, v in a.items() if v.norm() > 1e-6)
    return out


def train(steps, seed=0, out_dir="."):
    """Both loops at once, each in a process of its own, then ``compare``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    outs = {side: out_dir / f"nr_port_parity_{side}.json" for side in ("jax", "port")}
    procs = [subprocess.Popen([sys.executable, __file__, "side", side, str(steps), str(outs[side]),
                               "--seed", str(seed)]) for side in outs]
    try:
        failed = [p.args[3] for p in procs if p.wait() != 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise SystemExit(f"sides {failed} failed")
    return compare(outs["jax"], outs["port"])


def evaluate(ckpt, dtype):
    """The JAX script's scores and the port's of the weights in ``ckpt``."""
    sd = load_payload(ckpt)["state_dict"]
    params = {"backbone": convert_backbone_state_dict({k: v.numpy() for k, v in sd.items()}, prefix="backbone.")}
    back = state_dict_from_jax(params)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    jm = JaxDiffSepModel(jax_compose(nr.nr_overrides(dtype, False)))
    pm = nr.build_model(dtype, False, "cpu", 0)
    pm.score_model.load_state_dict(sd, strict=True)
    mix, tgt = nr.make_batch(np.random.default_rng(nr.HELDOUT_SEED), nr.HELDOUT_BATCH, nr.SAMPLES)
    clean, key = tgt[:, :1], jax.random.PRNGKey(nr.EVAL_SEED)
    si_sdr = JaxSISDRLoss(zero_mean=True, clamp_db=30, reduction="mean", sign_flip=True)
    pesq_wb = JaxPESQ(mode="wb", fs=nr.FS, max_items=8)
    out = {"ckpt": str(ckpt), "dtype": dtype}
    for name, kw in (("pc_n30", dict(N=30)),
                     ("ddim_n4", dict(predictor_name="ddim", corrector_name="none", N=4, schedule="log"))):
        est, _ = jm.separate(params, key, jnp.asarray(mix), **kw)
        est = np.asarray(est)[:, :1]
        same = nr.enhance_scores(pm, mix, tgt, noise=jax_pc_noise(key, tgt.shape, kw["N"]), **kw)
        own = nr.enhance_scores(pm, mix, tgt, **kw)
        out[name] = {"jax": [float(si_sdr(jnp.asarray(est), jnp.asarray(clean))), float(pesq_wb(est, clean))],
                     "port_jax_draws": list(same[:2]), "port_own_generator": list(own[:2])}
        print(json.dumps({name: out[name]}), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    t = sub.add_parser("train")
    t.add_argument("steps", nargs="?", type=int, default=500)
    t.add_argument("--work-dir", default=".", help="where each side writes its losses and weights")
    s = sub.add_parser("side")
    s.add_argument("side", choices=["jax", "port"])
    s.add_argument("steps", type=int)
    s.add_argument("side_out")
    s.add_argument("--perturb", type=float, default=0.0, help="the port's init scaled by 1 + perturb x N(0, 1)")
    c = sub.add_parser("compare")
    c.add_argument("jax_out")
    c.add_argument("port_out")
    e = sub.add_parser("eval")
    e.add_argument("ckpt")
    e.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    for p in (t, s):
        p.add_argument("--seed", type=int, default=0)
    for p in (t, c, e):
        p.add_argument("--out", default=None, help="write the result here as JSON")
    args = ap.parse_args(argv)
    if args.mode == "side":
        train_side(args.side, args.steps, args.seed, args.side_out, args.perturb)
        return 0
    if args.mode == "train":
        result = train(args.steps, args.seed, args.work_dir)
    elif args.mode == "compare":
        result = compare(args.jax_out, args.port_out)
    else:
        result = evaluate(args.ckpt, args.dtype)
    print(json.dumps({k: v for k, v in result.items() if k != "losses"}), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
