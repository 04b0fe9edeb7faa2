#!/usr/bin/env python3
"""The enhancement recipe's distillation check of the PyTorch/CUDA port: the
JAX package's scripts/distill_demo_nr.py, trained, distilled and sampled by
diffsep_tpu_torch.

The teacher is scripts/torch_port_train_demo_nr.py's (``model=nr``: nf 32,
bf16, batch 16 x 1 s at 16 kHz, Adam 1e-3, its EMA weights), trained here or
loaded from its weights file. It is scored on the 8 held-out clips with the
PC sampler (N=30) and with ddim at each stage's N on the ``--schedule``
grid; then the halving schedule (``train/distill.py:progressive_distill``)
distills a ddim student for each N of ``--stages`` from the previous
stage's EMA weights, and each student is scored at its N. Every score is
the SI-SDR and the PESQ-wb of the clean estimate (channel 0) against the
unprocessed noisy floor.

    python scripts/torch_port_distill_demo_nr.py [teacher_steps]
        [--distill-steps K] [--stages 4,2,1] [--schedule log] [--batch 16]
        [--seed 0] [--teacher-ckpt PATH] [--stage-cache-dir DIR] [--out PATH]
        [--dtype bfloat16|float32] [--device cpu] [--tiny]

``--teacher-ckpt PATH`` loads the teacher from the port's weights file at
PATH where it exists (``torch_port_train_demo_nr.py --save-ckpt`` writes
it, with a provenance sidecar PATH.json whose ``teacher_steps`` and ``seed``
must match the arguments), else trains it and saves it there.
``--stage-cache-dir`` makes the distillation resumable: each finished
stage's EMA weights are kept there and a rerun loads them (key the
directory by teacher, seed, schedule and steps).

Seeds, as the JAX script takes them: the teacher's data stream is
``default_rng(seed)``, its init and step draws those of
torch_port_train_demo_nr.py at that seed; the distillation cycles a pool
of 96 batches from ``default_rng(777 + seed)``, held on the card, and draws
from ``42 + seed``; the held-out set and the sampler's generator are the
training demo's. The record has every key of
scripts/distill_demo_nr_result.json, plus the card, seconds and hand-kernel
launches per distill step, and the bar of ``BAR``. ``--tiny`` rehearses on
the CPU at the training demo's tiny sizes. Without ``--device`` the demo
runs on the card, and raises where there is none.
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

import torch_port_train_demo as demo  # noqa: E402  (the port's training loop, teacher file)
import torch_port_train_demo_nr as nr  # noqa: E402  (the recipe: data, config, evaluation)

POOL_BATCHES, POOL_SEED, DISTILL_SEED, LOG_EVERY = 96, 777, 42, 250
# the JAX package's record (scripts/distill_demo_nr_result.json, one seed):
# teacher PC N=30 20.35 dB; students ddim N=4 / 2 / 1 14.63 / 15.14 / 13.40 dB,
# PESQ-wb 3.531 / 3.297 / 3.206; student N=1 1.11 dB above the teacher's ddim N=1
BAR = {"si_sdr_teacher_pc_n30_db": 18.8,
       "si_sdr_student_ddim_n4_db": 13.1, "si_sdr_student_ddim_n2_db": 13.6, "si_sdr_student_ddim_n1_db": 11.9,
       "pesq_wb_student_ddim_n4": 3.23, "pesq_wb_student_ddim_n2": 3.00, "pesq_wb_student_ddim_n1": 2.90}


def check_bar(result):
    """Each bar whose metric the record holds: {metric: met}; and the
    student at N=1 not below the same run's teacher at ddim N=1."""
    met = {k: bool(result[k] >= v) for k, v in BAR.items() if k in result}
    if "si_sdr_student_ddim_n1_db" in result:
        met["student_n1_vs_teacher_ddim_n1"] = bool(
            result["si_sdr_student_ddim_n1_db"] >= result["si_sdr_teacher_ddim_n1_db"])
    return met


def mismatch(teacher_steps, seed):
    """The JAX script's provenance check of a teacher's sidecar: its message
    where the sidecar's steps or seed differ from the arguments, else
    None."""

    def check(meta):
        if meta["teacher_steps"] != teacher_steps or meta.get("seed", 0) != seed:
            return (f"holds a {meta['teacher_steps']}-step seed={meta.get('seed', 0)} teacher but the arguments "
                    f"say {teacher_steps}/seed={seed}; delete the cache or match them")
        return None

    return check


def train_teacher(model, teacher_steps, seed, b, n, ckpt=None, log=print):
    """Train the teacher as torch_port_train_demo_nr.py does at ``seed`` and
    leave its EMA weights in ``model``; save them to ``ckpt`` where given.
    Returns the training time (s)."""
    return demo.train_teacher(model, teacher_steps, seed, b, n, ckpt, log, make=nr.make_batch)


def distill_pool(seed, b, n, device):
    """The JAX script's pool: POOL_BATCHES batches from ``default_rng(777 +
    seed)``, on ``device``."""
    import torch

    drng = np.random.default_rng(POOL_SEED + seed)
    return [tuple(torch.from_numpy(a).to(device) for a in nr.make_batch(drng, b, n)) for _ in range(POOL_BATCHES)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("teacher_steps", nargs="?", type=int, default=2000)
    ap.add_argument("--distill-steps", type=int, default=1500)
    ap.add_argument("--stages", default="4,2,1")
    ap.add_argument("--schedule", default="log", choices=["linear", "log", "revlog", "none"])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--teacher-ckpt", default=None,
                    help="the port's weights file: load the nr teacher from it if it exists, else train and "
                    "save it (its sidecar's teacher_steps and seed must match)")
    ap.add_argument("--stage-cache-dir", default=None,
                    help="resumable distillation: finished stages' EMA weights are kept here and loaded on "
                    "rerun (key the directory by teacher, seed, schedule and steps)")
    ap.add_argument("--out", default=str(HERE / "torch_port_distill_demo_nr_result.json"))
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--device", default=None, help="cpu, cuda or cuda:N (default: the card)")
    ap.add_argument("--tiny", action="store_true", help="a CPU rehearsal at nf 8, 0.5 s clips")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    sizes = nr.TINY if args.tiny else {"nf": nr.NF, "samples": nr.SAMPLES, "heldout": nr.HELDOUT_BATCH}
    b, n = (nr.TINY["batch"] if args.tiny else args.batch), sizes["samples"]
    model = nr.build_model(args.dtype, False, args.device, args.seed, nf=sizes["nf"])

    # held-out evaluation: SI-SDR and PESQ-wb of the clean channel
    mix_te, tgt_te = nr.make_batch(np.random.default_rng(nr.HELDOUT_SEED), sizes["heldout"], n)
    si_floor, pesq_floor = nr.floors(mix_te, tgt_te)

    def score(result, prefix, **kw):
        si, pq, _ = nr.enhance_scores(model, mix_te, tgt_te, **kw)
        result[f"si_sdr_{prefix}_db"], result[f"pesq_wb_{prefix}"] = round(si, 2), round(pq, 3)
        return f"{round(si, 2)} dB / PESQ {round(pq, 3)}"

    # a pool of batches on the card, cycled
    pool = distill_pool(args.seed, b, n, model.device)
    demo.distill_demo(model, args, {"si_sdr_noisy_floor_db": round(si_floor, 2),
                                    "pesq_wb_noisy_floor": round(pesq_floor, 3)},
                      score, lambda step: pool[step % len(pool)],
                      lambda model, ckpt: train_teacher(model, args.teacher_steps, args.seed, b, n, ckpt),
                      mismatch(args.teacher_steps, args.seed), lambda result: {"bar": BAR, "bar_met": check_bar(result)},
                      tiny=nr.TINY if args.tiny else None, seed=DISTILL_SEED + args.seed, log_every=LOG_EVERY)
    return 0


if __name__ == "__main__":
    sys.exit(main())
