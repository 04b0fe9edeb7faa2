#!/usr/bin/env python3
"""The separation distillation demo's scores of the port's weights by the JAX
package's evaluation code (scripts/distill_demo.py's ``eval_si_sdr``) and by
the port's (scripts/torch_port_distill_demo.py), on the CPU: the bisect of a
missed bar. It imports both packages, so it runs where JAX does, never on
the card.

    JAX_PLATFORMS=cpu python scripts/distill_port_parity.py WEIGHTS [WEIGHTS ...]
        [--sampler ddim|pc] [-N 2] [--schedule none|linear|log|revlog]
        [--dtype float32|bfloat16] [--out PATH]

Each WEIGHTS is a teacher weights file (``torch_port_train_demo.py
--save-ckpt``) or a stage of a stage cache (``torch_port_distill_demo.py
--stage-cache-dir``: ``stage{i}_N{n}.pt``). Its weights separate the 8
held-out mixtures with the JAX model (``separate`` from ``PRNGKey(7)``) and
with the port's, once with the JAX sampler's draws and once with the port's
own generator (seeded 7), each scored by the JAX script's SI-SDR of both
sources.
"""
import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for _p in (str(HERE.parent), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_port_train_demo as demo  # noqa: E402
from jax_draws import jax_pc_noise  # noqa: E402
from diffsep_tpu.config import compose as jax_compose  # noqa: E402
from diffsep_tpu.model import DiffSepModel as JaxDiffSepModel  # noqa: E402
from diffsep_tpu.models.convert import convert_backbone_state_dict  # noqa: E402
from diffsep_tpu.models.losses import SISDRLoss as JaxSISDRLoss  # noqa: E402
from diffsep_tpu_torch.models import state_dict_from_jax  # noqa: E402
from diffsep_tpu_torch.train.checkpoints import load_payload  # noqa: E402


def weights_of(path):
    """The score model's state dict in a teacher file or a stage file."""
    payload = load_payload(path)
    return payload["state_dict"] if "state_dict" in payload else payload


def evaluate(paths, sampler="ddim", n_steps=2, schedule=None, dtype="float32", nf=demo.NF, samples=demo.SAMPLES,
             heldout=demo.HELDOUT_BATCH):
    """{path: {"jax", "port_jax_draws", "port_own_generator"}} SI-SDR (dB)
    of each file's separations of the held-out set; ``nf``, ``samples`` and
    ``heldout`` are the demo's sizes unless given."""
    kw = dict(N=n_steps) if sampler == "pc" else dict(predictor_name="ddim", corrector_name="none", N=n_steps,
                                                      schedule=schedule)
    jm = JaxDiffSepModel(jax_compose(demo.demo_overrides(dtype, False, nf=nf)))
    pm = demo.build_model(dtype, False, "cpu", 0, nf=nf)
    mix, tgt = demo.make_batch(np.random.default_rng(demo.HELDOUT_SEED), heldout, samples)
    key = jax.random.PRNGKey(demo.EVAL_SEED)
    metric = JaxSISDRLoss(zero_mean=True, clamp_db=30, reduction="mean", sign_flip=True)
    noise = jax_pc_noise(key, tgt.shape, n_steps)
    mix_t, tgt_t = torch.from_numpy(mix), torch.from_numpy(tgt)
    out = {}
    for path in paths:
        sd = weights_of(path)
        params = {"backbone": convert_backbone_state_dict({k: v.numpy() for k, v in sd.items()}, prefix="backbone.")}
        back = state_dict_from_jax(params)
        assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
        est, _ = jm.separate(params, key, jnp.asarray(mix), **kw)
        pm.score_model.load_state_dict(sd, strict=True)
        out[str(path)] = {
            "jax": round(float(metric(jnp.asarray(np.asarray(est, np.float32)), jnp.asarray(tgt))), 2),
            "port_jax_draws": round(demo.heldout_si_sdr(pm, mix_t, tgt_t, noise=noise, **kw)[0], 2),
            "port_own_generator": round(demo.heldout_si_sdr(pm, mix_t, tgt_t, **kw)[0], 2),
        }
        print(json.dumps({str(path): out[str(path)]}), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("weights", nargs="+")
    ap.add_argument("--sampler", default="ddim", choices=["ddim", "pc"])
    ap.add_argument("-N", type=int, default=2)
    ap.add_argument("--schedule", default="none", choices=["none", "linear", "log", "revlog"])
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--out", default=None, help="write the result here as JSON")
    args = ap.parse_args(argv)
    schedule = None if args.schedule == "none" else args.schedule
    result = {"sampler": args.sampler, "N": args.N, "schedule": schedule, "dtype": args.dtype,
              "scores": evaluate(args.weights, args.sampler, args.N, schedule, args.dtype)}
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
