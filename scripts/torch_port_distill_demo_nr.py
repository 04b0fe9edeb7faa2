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
import json
import logging
import sys
import time
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


def load_teacher(model, ckpt, teacher_steps, seed):
    """Load the teacher's weights file into ``model``, after its sidecar's
    provenance check (the JAX script's message where it differs). Returns
    the sidecar."""
    from diffsep_tpu_torch.train.checkpoints import load_payload

    meta = json.loads(ckpt.with_suffix(".json").read_text())
    if meta["teacher_steps"] != teacher_steps or meta.get("seed", 0) != seed:
        raise SystemExit(
            f"{ckpt} holds a {meta['teacher_steps']}-step seed={meta.get('seed', 0)} teacher but the "
            f"arguments say {teacher_steps}/seed={seed}; delete the cache or match them")
    model.score_model.load_state_dict(load_payload(ckpt, map_location=model.device)["state_dict"], strict=True)
    return meta


def train_teacher(model, teacher_steps, seed, b, n, ckpt=None, log=print):
    """Train the teacher as torch_port_train_demo_nr.py does at ``seed`` and
    leave its EMA weights in ``model``; save them to ``ckpt`` where given.
    Returns the training time (s)."""
    from diffsep_tpu_torch.train.distill import ema_state_dict

    run = nr.train(model, seed, teacher_steps, np.random.default_rng(seed), b, n, log=lambda m: log(f"teacher {m}"))
    record = {"steps": teacher_steps, "train_time_s": round(run["train_time_s"], 1), "seed": seed}
    if ckpt is not None:
        demo.save_teacher(ckpt, model, run["state"], record)
        log(f"teacher saved to {ckpt}")
    model.score_model.load_state_dict(ema_state_dict(model, run["state"]), strict=True)
    return run["train_time_s"]


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
    stages = tuple(int(s) for s in args.stages.split(","))
    schedule = None if args.schedule == "none" else args.schedule
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    import torch

    from diffsep_tpu_torch.ops import _build
    from diffsep_tpu_torch.train.distill import progressive_distill

    def log(msg):
        print(msg, flush=True)

    sizes = nr.TINY if args.tiny else {"nf": nr.NF, "samples": nr.SAMPLES, "heldout": nr.HELDOUT_BATCH}
    b, n = (nr.TINY["batch"] if args.tiny else args.batch), sizes["samples"]
    model = nr.build_model(args.dtype, False, args.device, args.seed, nf=sizes["nf"])
    dev = model.device

    # --- teacher: load, or train and save ---
    ckpt = Path(args.teacher_ckpt) if args.teacher_ckpt else None
    if ckpt is not None and ckpt.exists():
        meta = load_teacher(model, ckpt, args.teacher_steps, args.seed)
        teacher_time = float(meta.get("teacher_train_time_s", 0.0))
        log(f"teacher loaded from {ckpt} ({meta})")
    else:
        teacher_time = train_teacher(model, args.teacher_steps, args.seed, b, n, ckpt, log)

    # --- held-out evaluation: SI-SDR and PESQ-wb of the clean channel ---
    mix_te, tgt_te = nr.make_batch(np.random.default_rng(nr.HELDOUT_SEED), sizes["heldout"], n)
    si_floor, pesq_floor = nr.floors(mix_te, tgt_te)
    result = {
        "teacher_steps": args.teacher_steps,
        "seed": args.seed,
        "teacher_train_time_s": round(teacher_time, 1),
        "distill_steps_per_stage": args.distill_steps,
        "stages": list(stages),
        "schedule": schedule,
        "si_sdr_noisy_floor_db": round(si_floor, 2),
        "pesq_wb_noisy_floor": round(pesq_floor, 3),
    }

    def score(prefix, **kw):
        si, pq, _ = nr.enhance_scores(model, mix_te, tgt_te, **kw)
        result[f"si_sdr_{prefix}_db"], result[f"pesq_wb_{prefix}"] = round(si, 2), round(pq, 3)

    # the teacher first: progressive_distill leaves the last student's weights loaded
    score("teacher_pc_n30", N=nr.PC_N)
    for k in sorted(set(stages)):
        score(f"teacher_ddim_n{k}", predictor_name="ddim", corrector_name="none", N=k, schedule=schedule)
    log(json.dumps(result))

    # --- progressive distillation over a pool of batches on the card ---
    pool = distill_pool(args.seed, b, n, dev)
    trained = 0

    def batch_fn(step):
        nonlocal trained
        trained += 1
        return pool[step % len(pool)]

    _build.reset_counts()
    t0 = time.perf_counter()
    students = progressive_distill(model, batch_fn, stages=stages, steps_per_stage=args.distill_steps,
                                   seed=DISTILL_SEED + args.seed, log_every=LOG_EVERY,
                                   stage_cache_dir=args.stage_cache_dir, schedule=schedule)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    distill_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    result["distill_time_s"] = round(distill_s, 1)

    for k, state_dict in students.items():
        model.score_model.load_state_dict(state_dict, strict=True)
        score(f"student_ddim_n{k}", predictor_name="ddim", corrector_name="none", N=k, schedule=schedule)
        log(f"stage N={k}: student {result[f'si_sdr_student_ddim_n{k}_db']} dB / PESQ "
            f"{result[f'pesq_wb_student_ddim_n{k}']} vs teacher {result[f'si_sdr_teacher_ddim_n{k}_db']} dB / "
            f"{result[f'pesq_wb_teacher_ddim_n{k}']}")

    result.update(
        dtype=args.dtype,
        distill_steps_trained=trained,
        s_per_distill_step=distill_s / trained if trained else None,
        launches_per_distill_step={k: v / trained for k, v in sorted(launches.items())} if trained else {},
        backward_launches_per_distill_step=(
            {k: v / trained for k, v in sorted(_build.backward_counts.items())} if trained else {}),
        device=str(dev),
        card=demo.card_name(dev),
        bar=BAR,
        bar_met=check_bar(result),
    )
    if args.tiny:
        result["tiny"] = nr.TINY
    print(json.dumps(result), flush=True)
    Path(args.out).write_text(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
