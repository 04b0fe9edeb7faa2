#!/usr/bin/env python3
"""The separation recipe's distillation check of the PyTorch/CUDA port: the
JAX package's scripts/distill_demo.py, and the distillation half of
scripts/seed_spread.py, trained, distilled and sampled by diffsep_tpu_torch.

The teacher is scripts/torch_port_train_demo.py's (nf 32, ch_mult (1, 1, 2),
bf16, batch 16 x 1 s at 8 kHz, ``train_source_order=power``, its EMA
weights), loaded from its weights file or trained here. It separates the 8
held-out mixtures with the PC sampler (N=30) and with ddim at each stage's N
on the ``--schedule`` grid; then the halving schedule
(``train/distill.py:progressive_distill``) distills a ddim student for each
N of ``--stages`` from the previous stage's EMA weights, optionally from its
own rollouts (``--on-policy-frac``), and each student separates them at its
N. Every score is the SI-SDR of both sources.

    python scripts/torch_port_distill_demo.py [teacher_steps]
        [--distill-steps K] [--stages 8,4,2,1] [--schedule none|linear|log|revlog]
        [--on-policy-frac F] [--batch 16] [--seed 0] [--teacher-ckpt PATH]
        [--stage-cache-dir DIR] [--out PATH] [--dtype bfloat16|float32]
        [--device cpu] [--tiny]
    python scripts/torch_port_distill_demo.py 10000 --seeds 0,1,2 --schedule log
        --stages 2,1 --distill-steps 6000 --teacher-ckpt DIR/teacher.pt
        [--stage-cache-dir DIR] [--out-dir DIR]

``--teacher-ckpt PATH`` loads the teacher from the port's weights file at
PATH where it exists (``torch_port_train_demo.py --save-ckpt`` writes it,
with a provenance sidecar PATH.json whose ``teacher_steps`` and ``seed``
must match the arguments), else trains it and saves it there.
``--stage-cache-dir`` makes the distillation resumable: each finished
stage's EMA weights are kept there and a rerun loads them (key the
directory by teacher, seed, schedule and steps); the rerun's batch stream
skips the batches of the loaded stages, so that it trains on the batches of
an uncut run.

Seeds, as the JAX script takes them: the teacher's data stream is
``default_rng(seed)``, its init and step draws those of
torch_port_train_demo.py at that seed; every distill step draws a fresh
batch from ``default_rng(777 + seed)`` and its draws from ``42 + seed``;
the held-out set (``default_rng(123)``) and the sampler's generator (seeded
7) are the training demo's. The record has every key of
scripts/distill_demo_result.json, plus the card, seconds and hand-kernel
launches per distill step, the gains of the students over the teacher's
ddim, and the bar of ``BAR`` for the run's kind.

``--seeds`` runs each seed in a process of its own, all at once (seed S's
teacher ``PATH`` with ``_seed{S}`` before the suffix, its stage cache
``DIR/seed{S}``), writes DIR/torch_port_distill_demo_{schedule}_seed{S}.json
and then DIR/torch_port_distill_demo_{schedule}_spread.json: every si_sdr_*
metric and distill gain as {mean, min, max, spread, values} over the seeds,
as scripts/seed_spread.py aggregates the JAX package's records, with the bar
checked. ``--tiny`` rehearses on the CPU at the training demo's tiny sizes.
Without ``--device`` the demo runs on the card, and raises where there is
none.
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
for _p in (str(HERE.parent), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch_port_train_demo as demo  # noqa: E402  (the port's training loop, data, teacher file)
from torch_port_train_demo import train_teacher  # noqa: E402

BATCH_SEED, DISTILL_SEED, LOG_EVERY = 777, 42, 250
# Bars by the run's kind (``bar_kind``): the JAX package's records less a
# margin, each a least value for each seed (``each``) and for the seeds'
# mean (``mean``). A gain is the student's SI-SDR less the same run's
# teacher's ddim at the student's N: it does not move with the teacher.
BAR = {
    # scripts/distill_demo_log_spread.json (three seeds, stages 2, 1 of 6000
    # steps): students N=2 20.39-21.68 dB (mean 21.12), N=1 13.38-14.62
    # (14.04), gains +5.00 to +5.63 and +3.53 to +3.71, teacher PC N=30
    # 25.83-26.05: the lowest seed or the mean less 1 dB
    "log": {"si_sdr_student_ddim_n2_db": {"each": 19.4, "mean": 20.1},
            "si_sdr_student_ddim_n1_db": {"each": 12.4, "mean": 13.0},
            "si_sdr_delta_distill_gain_n2_db": {"each": 4.0},
            "si_sdr_delta_distill_gain_n1_db": {"each": 2.5},
            "si_sdr_teacher_pc_n30_db": {"each": 24.8, "mean": 24.9}},
    # scripts/distill_demo_result.json (seed 0, the linear grid, stages 8, 4,
    # 2, 1 of 1500 steps): students 23.83 / 22.03 / 6.14 / 13.05 dB, gains
    # -0.09 / +0.46 / +9.47 / +2.24
    "none": {"si_sdr_delta_distill_gain_n8_db": {"each": -1.0},
             "si_sdr_delta_distill_gain_n4_db": {"each": -1.0},
             "si_sdr_delta_distill_gain_n2_db": {"each": 0.01},
             "si_sdr_delta_distill_gain_n1_db": {"each": 0.01},
             "si_sdr_student_ddim_n4_db": {"each": 21.0}},
    # scripts/distill_demo_onpolicy_result.json (seed 0, the log grid, stage
    # 2 of 1500 steps, on-policy 0.5): the student 18.11 dB, the teacher's
    # ddim N=2 17.09
    "onpolicy": {"si_sdr_delta_distill_gain_n2_db": {"each": 0.01}},
}


def bar_kind(record):
    """The kind of run a record comes from: "onpolicy", or its schedule
    ("none" for the JAX script's default grid)."""
    if record.get("on_policy_frac", 0.0) > 0.0:
        return "onpolicy"
    return record["schedule"] or "none"


def check_bar(records, each_only=False):
    """The bar of the records' kind, on the metrics that every record holds,
    and {metric: met} over the records (one seed's, or the seeds' of a
    spread); ``each_only`` leaves out the bars on the mean (one seed's
    record). Returns (bar, met)."""
    records = [demo.add_derived_deltas(r) for r in records]
    bar = {k: v for k, v in BAR.get(bar_kind(records[0]), {}).items() if all(k in r for r in records)}
    if each_only:
        bar = {k: {"each": v["each"]} for k, v in bar.items()}
    return bar, demo.check_bar(records, bar)


def spread_record(records, teacher_steps):
    """The seeds' spread of every si_sdr_* metric and distill gain (the
    distillation half of scripts/seed_spread.py), with the runs' card,
    speed and launches, and the bar checked on the records."""
    records = [demo.add_derived_deltas(r) for r in records]
    agg = demo.aggregate(records, lambda k: k.startswith("si_sdr_"))
    first = records[0]
    agg.update(teacher_steps=teacher_steps, distill_steps_per_stage=first["distill_steps_per_stage"],
               stages=first["stages"], schedule=first["schedule"], on_policy_frac=first["on_policy_frac"],
               card=[r["card"] for r in records], s_per_distill_step=[r["s_per_distill_step"] for r in records],
               launches_per_distill_step=first["launches_per_distill_step"])
    agg["bar"], agg["bar_met"] = check_bar(records)
    return agg


class BatchStream:
    """The JAX script's distillation data: a fresh ``make_batch`` from
    ``default_rng(777 + seed)`` at every call, on ``device``. ``skip_to(k)``
    makes and drops batches until k have been made; ``served`` counts the
    calls."""

    def __init__(self, seed, b, n, device):
        self.rng = np.random.default_rng(BATCH_SEED + seed)
        self.b, self.n, self.device = b, n, device
        self.made = self.served = 0

    def _next(self):
        self.made += 1
        return demo.make_batch(self.rng, self.b, self.n)

    def skip_to(self, k):
        while self.made < k:
            self._next()

    def __call__(self):
        from diffsep_tpu_torch.train.loop import to_device

        self.served += 1
        return tuple(to_device(a, self.device) for a in self._next())


def stage_batches(stream, stages, steps, cache_dir=None):
    """``batch_fn(step)`` for ``progressive_distill``: each stage that
    trains takes the batches an uncut run gives it, steps x its index on,
    the stages the cache holds being loaded, not trained."""
    from diffsep_tpu_torch.train.distill import stage_cache_file

    trained = iter([i for i, k in enumerate(stages)
                    if cache_dir is None or not stage_cache_file(cache_dir, i, k).exists()])

    def batch_fn(step):
        if step == 0:
            stream.skip_to(next(trained) * steps)
        return stream()

    return batch_fn


def mismatch(teacher_steps, seed):
    """The JAX script's provenance checks of a teacher's sidecar: its
    message where the sidecar's steps or seed differ from the arguments,
    else None."""

    def check(meta):
        if meta["teacher_steps"] != teacher_steps:
            return (f"holds a {meta['teacher_steps']}-step teacher but the teacher_steps argument is "
                    f"{teacher_steps}; delete the cache or pass the matching step count as the positional "
                    "teacher_steps argument")
        if meta.get("seed", 0) != seed:
            return f"holds a seed={meta.get('seed', 0)} teacher but --seed is {seed}; delete the cache or match the seed"
        return None

    return check


def score(model, mix, tgt, **kw):
    """SI-SDR (dB, to 0.01) of the held-out separations with the weights
    ``model`` holds."""
    return round(demo.heldout_si_sdr(model, mix, tgt, **kw)[0], 2)


def run_seeds(args):
    """Each seed of ``--seeds`` in a process of its own, then the spread."""
    seeds = [int(s) for s in args.seeds.split(",")]

    def extra(seed):
        flags = ["--distill-steps", str(args.distill_steps), "--stages", args.stages, "--schedule", args.schedule,
                 "--on-policy-frac", str(args.on_policy_frac), "--batch", str(args.batch)]
        if args.teacher_ckpt:
            flags += ["--teacher-ckpt", str(demo.seed_path(args.teacher_ckpt, seed))]
        if args.stage_cache_dir:
            flags += ["--stage-cache-dir", str(Path(args.stage_cache_dir) / f"seed{seed}")]
        return flags

    shared = argparse.Namespace(**vars(args), steps=args.teacher_steps, remat=False)
    return demo.run_seeds(shared, seeds, script=__file__, prefix=f"torch_port_distill_demo_{args.schedule}",
                          spread=spread_record, extra=extra)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("teacher_steps", nargs="?", type=int, default=3000)
    ap.add_argument("--distill-steps", type=int, default=1500)
    ap.add_argument("--stages", default="8,4,2,1")
    ap.add_argument("--schedule", default="none", choices=["none", "linear", "log", "revlog"],
                    help="the time grid; none is the JAX script's default (None: linspace(T, eps, N))")
    ap.add_argument("--on-policy-frac", type=float, default=0.0)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--stage-cache-dir", default=None,
                    help="resumable distillation: finished stages' EMA weights are kept here and loaded on "
                    "rerun (key the directory by teacher, seed, schedule and steps)")
    ap.add_argument("--teacher-ckpt", default=None,
                    help="the port's weights file: load the teacher from it if it exists, else train and "
                    "save it (its sidecar's teacher_steps and seed must match)")
    ap.add_argument("--out", default=str(HERE / "torch_port_distill_demo_result.json"))
    ap.add_argument("--seed", type=int, default=0,
                    help="the teacher's data, init and draws and the distillation's batches and draws; the "
                    "held-out set and the sampler's generator stay fixed")
    ap.add_argument("--seeds", default=None, help="comma-separated seeds, each run in a process of its own")
    ap.add_argument("--out-dir", default=str(HERE), help="where --seeds writes its records")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--device", default=None, help="cpu, cuda or cuda:N (default: the card)")
    ap.add_argument("--tiny", action="store_true", help="a CPU rehearsal at nf 8, batch 2 x 2000 samples")
    args = ap.parse_args(argv)
    if args.seeds:
        run_seeds(args)
        return 0
    stages = tuple(int(s) for s in args.stages.split(","))
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    import torch

    def log(msg):
        print(f"[seed {args.seed}] {msg}", flush=True)

    sizes = demo.TINY if args.tiny else {"nf": demo.NF, "samples": demo.SAMPLES, "heldout": demo.HELDOUT_BATCH}
    b, n = (demo.TINY["batch"] if args.tiny else args.batch), sizes["samples"]
    model = demo.build_model(args.dtype, False, args.device, args.seed, nf=sizes["nf"])
    dev = model.device
    mix_te, tgt_te = (torch.from_numpy(a).to(dev) for a in
                      demo.make_batch(np.random.default_rng(demo.HELDOUT_SEED), sizes["heldout"], n))

    def record_score(result, prefix, **kw):
        result[f"si_sdr_{prefix}_db"] = score(model, mix_te, tgt_te, **kw)
        return f"{result[f'si_sdr_{prefix}_db']} dB"

    def extra(result):
        bar, met = check_bar([result], each_only=True)
        deltas = {key: v for key, v in demo.add_derived_deltas(result).items() if key.startswith("si_sdr_delta_")}
        return dict(deltas, batch=b, bar=bar, bar_met=met)

    # a fresh batch every distill step
    batch_fn = stage_batches(BatchStream(args.seed, b, n, dev), stages, args.distill_steps, args.stage_cache_dir)
    demo.distill_demo(model, args, {"on_policy_frac": args.on_policy_frac}, record_score, batch_fn,
                      lambda model, ckpt: train_teacher(model, args.teacher_steps, args.seed, b, n, ckpt, log),
                      mismatch(args.teacher_steps, args.seed), extra, log=log,
                      tiny=demo.TINY if args.tiny else None, seed=DISTILL_SEED + args.seed, log_every=LOG_EVERY,
                      on_policy_frac=args.on_policy_frac)
    return 0


if __name__ == "__main__":
    sys.exit(main())
