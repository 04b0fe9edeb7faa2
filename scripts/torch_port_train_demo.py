#!/usr/bin/env python3
"""The separation learning check of the PyTorch/CUDA port: the learning demo
on synthetic separable mixtures, trained and sampled by diffsep_tpu_torch.

A small NCSN++ (nf 32, ch_mult (1, 1, 2), one res block, attention at 64,
bf16 compute, f32 parameters) learns the score of mixtures of two spectrally
disjoint sources (low-band against high-band filtered noise, made from a
seed) for ``steps`` Adam steps at batch 16 x 1 s, 8 kHz. Its EMA weights then
separate 8 held-out mixtures with the PC sampler (reverse_diffusion + ald2,
N=30), ddim N=6 and the ddim/dpmpp sweep at N = 4, 6, 8, each scored by
SI-SDR against the unprocessed-mixture floor. A working port clearly beats
the floor: this checks the whole loop (loss -> optimizer -> EMA -> sampler)
and both hand kernels with real gradient descent, not shapes.

    python scripts/torch_port_train_demo.py [steps] [--seed S]
        [--dtype bfloat16|float32] [--remat] [--out PATH] [--save-ckpt PATH]
        [--device cpu] [--tiny]
    python scripts/torch_port_train_demo.py 10000 --seeds 0,1,2 [--out-dir DIR]
        [--save-ckpt PATH]

Seeds: the data stream is numpy's ``default_rng(seed)``, draw for draw that
of the JAX package's scripts/train_demo.py; the weights are drawn from
``seed`` and the training step's draws from ``1000 * seed + 1`` (the JAX
script's PRNGKey(seed) and PRNGKey(1000 * seed + 1): threefry's draws
themselves cannot be reproduced in torch). The held-out set
(``default_rng(123)``) and the sampler's generator (seeded 7) are the same
for every seed, so the spread over seeds measures training variance on one
test protocol. The record has every key of scripts/train_demo_result.json,
plus the card, seconds and hand-kernel launches per step.

``--seeds`` runs each seed in a process of its own, all at once (one card
each where there are several, else sharing the one: training is host-bound),
writes DIR/torch_port_train_demo_seed{S}.json, then
DIR/torch_port_train_demo_spread.json: every si_sdr_* metric (and the
dpmpp-minus-ddim differences) as {mean, min, max, spread, values} over the
seeds, as scripts/seed_spread.py aggregates the JAX package's records, with
the bar of ``BAR`` checked. With ``--seeds``, ``--save-ckpt PATH`` writes
seed S's teacher as PATH with ``_seed{S}`` before the suffix
(scripts/torch_port_distill_demo.py loads it with ``--teacher-ckpt``).

``--tiny`` rehearses on the CPU: nf 8, batch 2 x 2000 samples, 2 held-out
mixtures of 2000 samples. Without ``--device`` the demo runs on the card,
and raises where there is none.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

FS, SAMPLES, BATCH, NF = 8000, 8000, 16, 32
HELDOUT_SEED, HELDOUT_BATCH, EVAL_SEED = 123, 8, 7
TINY = {"nf": 8, "batch": 2, "samples": 2000, "heldout": 2}
PC_N, FAST_N, SWEEP = 30, 6, (("ddim", "dpmpp"), (4, 6, 8))
# the JAX package's three seeds at 10000 steps (scripts/train_demo_spread.json):
# PC N=30 25.83-26.05 dB (mean 25.92), ddim N=6 from 15.99, the floor 0.00
BAR = {"si_sdr_separated_db": {"each": 24.8, "mean": 24.9},
       "si_sdr_ddim_n6_db": {"each": 15.0},
       "si_sdr_mixture_floor_db": {"abs": 0.01}}


class Recipe(NamedTuple):
    """What a learning demo trains and how it scores a seed:
    ``build(dtype, remat, device, seed, nf)`` the model, ``make(rng, b, n)``
    a batch (noisy or mixture, target), ``score(model, state, mix_te,
    tgt_te)`` the record's metrics and the score evaluations they took;
    ``sizes`` and ``tiny`` the nf, batch, samples and held-out clips of a
    run and of ``--tiny``."""
    build: Callable
    make: Callable
    score: Callable
    sizes: dict
    tiny: dict


def make_batch(rng, b, n, fs=FS):
    """Source 1: low-band noise; source 2: high-band noise. A copy of
    scripts/train_demo.py:make_batch: the same draws give the same arrays,
    bit for bit."""
    from scipy.signal import butter, lfilter

    lo_b, lo_a = butter(4, 500 / (fs / 2), "low")
    hi_b, hi_a = butter(4, 1500 / (fs / 2), "high")
    s1 = lfilter(lo_b, lo_a, rng.standard_normal((b, n)), axis=-1)
    s2 = lfilter(hi_b, hi_a, rng.standard_normal((b, n)), axis=-1)
    # distinct powers make the (non-PIT) power-ordered target well defined
    s1 = s1 / np.std(s1, axis=-1, keepdims=True) * 0.13
    s2 = s2 / np.std(s2, axis=-1, keepdims=True) * 0.07
    tgt = np.stack([s1, s2], axis=1).astype(np.float32)
    return tgt.sum(axis=1, keepdims=True), tgt


def demo_overrides(dtype="bfloat16", remat=False, nf=NF):
    """The JAX script's overrides of the default config."""
    return [
        f"model.score_model.backbone_args.nf={nf}",
        "model.score_model.backbone_args.ch_mult=[1,1,2]",
        "model.score_model.backbone_args.num_res_blocks=1",
        "model.score_model.backbone_args.attn_resolutions=[64]",
        f"model.score_model.backbone_args.dtype={dtype}",
        f"model.score_model.backbone_args.remat={str(remat).lower()}",
        "model.train_source_order=power",
        "model.optimizer.lr=0.001",
        "trainer.accumulate_grad_batches=1",
    ]


def build_model(dtype="bfloat16", remat=False, device=None, seed=0, nf=NF):
    from diffsep_tpu_torch.config.compose import compose
    from diffsep_tpu_torch.model import DiffSepModel

    return DiffSepModel(compose(demo_overrides(dtype, remat, nf)), device=device, seed=seed)


def train(model, seed, steps, rng, b=BATCH, n=SAMPLES, log=print, draws=None, make=make_batch):
    """``steps`` train steps on batches of ``make(rng, b, n)`` (this demo's
    ``make_batch`` unless given), after the one batch the JAX script draws
    for its init example. The host waits for the card only where the JAX
    script does: at step 0 and every 100 steps. ``draws(i)``, where given, hands step i's loss its draws (see
    ``losses.Draws``). Returns the train state, every step's loss, and the
    hand kernels' launches over the steps (cumulative at every 100th)."""
    import torch

    from diffsep_tpu_torch.ops import _build
    from diffsep_tpu_torch.train.loop import to_device

    dev = model.device
    make(rng, b, n)  # the JAX script's init example: keeps the data stream aligned
    state = model.init_state()
    step_fn = model.make_train_step(1000 * seed + 1)
    losses = torch.empty(steps, device=dev)
    curve, windows = [], []
    _build.reset_counts()
    t0 = time.perf_counter()
    for i in range(steps):
        mix, tgt = make(rng, b, n)
        metrics = step_fn(state, to_device(mix, dev), to_device(tgt, dev),
                          draws=None if draws is None else draws(i))
        losses[i] = metrics["train/score_loss"]
        if i == 0:
            loss0 = losses[0].item()
            t1 = time.perf_counter()
        if (i + 1) % 100 == 0:
            loss = losses[i].item()
            curve.append(round(loss, 4))
            windows.append(dict(_build.launch_counts))
            log(f"step {i + 1}: loss {loss:.4f}")
    losses = losses.cpu().numpy()
    t_end = time.perf_counter()
    counts = dict(_build.launch_counts)
    return {
        "state": state, "losses": losses, "loss_first": loss0, "loss_final": float(losses[-1]),
        "loss_curve_every100": curve, "train_time_s": t_end - t0,
        # after step 0, which builds the kernels and warms the allocator
        "s_per_step": (t_end - t1) / (steps - 1) if steps > 1 else t_end - t0,
        "launches": counts, "backward_launches": dict(_build.backward_counts),
        "launch_shapes": dict(_build.launch_shapes), "window_launches": windows,
    }


def si_sdr_metric():
    """The JAX scripts' metric: SI-SDR (dB) of both sources."""
    from diffsep_tpu_torch.models.losses import SISDRLoss

    return SISDRLoss(zero_mean=True, clamp_db=30, reduction="mean", sign_flip=True)


def heldout_si_sdr(model, mix, tgt, noise=None, **kw):
    """SI-SDR (dB) of the separations of the held-out tensors ``mix``,
    ``tgt`` with the weights ``model`` holds, the sampler's settings in
    ``kw``, drawing from a generator seeded EVAL_SEED (the JAX scripts'
    PRNGKey(7) for every sampler) or the given ``noise``. Returns (SI-SDR,
    score evaluations)."""
    import torch

    gen = torch.Generator(device=model.device).manual_seed(EVAL_SEED)
    est, nfe = model.separate(mix, generator=gen, noise=noise, **kw)
    return float(si_sdr_metric()(est.float(), tgt)), nfe


def evaluate(model, state, mix_te, tgt_te, noise=None):
    """SI-SDR (dB) of the EMA weights' separations of the held-out set with
    each sampler (``heldout_si_sdr``), and of the mixture floor.
    ``noise(sampler_kwargs)``, where given, hands each sampler its draws.
    Returns (metrics, score evaluations)."""
    import torch

    from diffsep_tpu_torch.train.ema import swapped

    dev = model.device
    mix = torch.from_numpy(mix_te).to(dev)
    tgt = torch.from_numpy(tgt_te).to(dev)
    nfe_total = 0

    def si_sdr(**kw):
        nonlocal nfe_total
        value, nfe = heldout_si_sdr(model, mix, tgt, noise=None if noise is None else noise(kw), **kw)
        nfe_total += nfe
        return value

    with swapped(state.ema, state.params):
        sep = si_sdr(N=PC_N)
        fast = si_sdr(predictor_name="ddim", corrector_name="none", N=FAST_N)
        sweep = {f"si_sdr_{pred}_n{k}_db": round(si_sdr(predictor_name=pred, corrector_name="none", N=k), 2)
                 for pred in SWEEP[0] for k in SWEEP[1]}
    floor = float(si_sdr_metric()(mix.expand_as(tgt), tgt))
    return {
        "si_sdr_mixture_floor_db": round(floor, 2),
        "si_sdr_separated_db": round(sep, 2),
        "si_sdr_ddim_n6_db": round(fast, 2),
        "improvement_db": round(sep - floor, 2),
        **sweep,
    }, nfe_total


SEPARATION = Recipe(build_model, make_batch, evaluate,
                    {"nf": NF, "batch": BATCH, "samples": SAMPLES, "heldout": HELDOUT_BATCH}, TINY)


def card_name(device):
    """The card's name and power limit as nvidia-smi gives them; None off
    the card."""
    if device.type != "cuda":
        return None
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def run_seed(steps, seed, dtype="bfloat16", remat=False, device=None, tiny=False, log=print, recipe=None):
    """One seed's training and evaluation of ``recipe`` (this demo's,
    ``SEPARATION``, unless given). Returns (record, model, state)."""
    import torch

    recipe = recipe or SEPARATION
    sizes = recipe.tiny if tiny else recipe.sizes
    model = recipe.build(dtype, remat, device, seed, nf=sizes["nf"])
    dev = model.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run = train(model, seed, steps, np.random.default_rng(seed), sizes["batch"], sizes["samples"], log=log,
                make=recipe.make)
    mix_te, tgt_te = recipe.make(np.random.default_rng(HELDOUT_SEED), sizes["heldout"], sizes["samples"])
    t0 = time.perf_counter()
    metrics, nfe = recipe.score(model, run["state"], mix_te, tgt_te)
    eval_s = time.perf_counter() - t0
    losses = run["losses"]
    record = {
        "steps": steps,
        "seed": seed,
        "dtype": dtype,
        "remat": bool(remat),
        "loss_curve_every100": run["loss_curve_every100"],
        "train_time_s": round(run["train_time_s"], 1),
        "loss_first": round(run["loss_first"], 4),
        "loss_final": round(run["loss_final"], 4),
        **metrics,
        # per-step losses are noisy (the JAX curve reads 0.49, 0.65, 0.16
        # at steps 100-300): learning is judged on windowed means
        "loss_mean_every100": [round(float(losses[i:i + 100].mean()), 4) for i in range(0, steps - 99, 100)],
        "s_per_step": run["s_per_step"],
        "launches_per_step": {k: v / steps for k, v in sorted(run["launches"].items())},
        "eval_nfe": nfe,
        "eval_s": eval_s,
        "device": str(dev),
        "card": card_name(dev),
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None,
    }
    if tiny:
        record["tiny"] = recipe.tiny
    return record, model, run["state"]


def save_teacher(path, model, state, record):
    """The EMA weights as the port's weights file (``cli.loading.load_model``
    reads it) and a provenance sidecar beside it, the JAX script's."""
    from diffsep_tpu_torch.config.compose import to_dict
    from diffsep_tpu_torch.train.checkpoints import atomic_save
    from diffsep_tpu_torch.train.ema import swapped

    path = Path(path)
    with swapped(state.ema, state.params):
        weights = {k: v.detach().cpu().clone() for k, v in model.score_model.state_dict().items()}
    atomic_save({"state_dict": weights, "config": to_dict(model.run_config)}, path)
    path.with_suffix(".json").write_text(json.dumps({
        "teacher_steps": record["steps"], "teacher_train_time_s": record["train_time_s"], "seed": record["seed"],
    }))


def train_teacher(model, steps, seed, b, n, ckpt=None, log=print, make=make_batch):
    """Train a distillation demo's teacher as this demo trains at ``seed``
    (on batches of ``make``) and leave its EMA weights in ``model``; save
    them to ``ckpt`` where given. Returns the training time (s)."""
    from diffsep_tpu_torch.train.distill import ema_state_dict

    run = train(model, seed, steps, np.random.default_rng(seed), b, n, log=lambda m: log(f"teacher {m}"), make=make)
    if ckpt is not None:
        save_teacher(ckpt, model, run["state"], {"steps": steps, "train_time_s": round(run["train_time_s"], 1),
                                                 "seed": seed})
        log(f"teacher saved to {ckpt}")
    model.score_model.load_state_dict(ema_state_dict(model, run["state"]), strict=True)
    return run["train_time_s"]


def load_teacher(model, ckpt, mismatch):
    """Load the teacher's weights file ``ckpt`` into ``model``; exit instead,
    with ``ckpt`` and ``mismatch(sidecar)``, where that names a fault in the
    provenance sidecar. Returns the sidecar."""
    from diffsep_tpu_torch.train.checkpoints import load_payload

    meta = json.loads(ckpt.with_suffix(".json").read_text())
    fault = mismatch(meta)
    if fault:
        raise SystemExit(f"{ckpt} {fault}")
    model.score_model.load_state_dict(load_payload(ckpt, map_location=model.device)["state_dict"], strict=True)
    return meta


def distill_demo(model, args, head, score, batch_fn, train_fn, mismatch, extra, log=print, tiny=None,
                 **distill_kw):
    """A distillation demo's run on ``model`` from the distill scripts'
    arguments ``args``: the teacher loaded from ``--teacher-ckpt`` (after
    ``mismatch``, as ``load_teacher`` takes it) or trained by
    ``train_fn(model, ckpt)``, which returns its seconds; the teacher scored
    first, with the PC sampler and with ddim at each stage's N, by
    ``score(record, prefix, **sampler)``, which writes its metrics into the
    record and returns them as text; ``progressive_distill`` on ``batch_fn``
    (``distill_kw``: its seed, logging and options); each student scored
    with its own stage's weights. The record (the arguments, ``head``, the
    scores, the distill time, seconds and hand-kernel launches per distill
    step, the card, then ``extra(record)``) is printed and written to
    ``args.out``. Returns it."""
    import torch

    from diffsep_tpu_torch.ops import _build
    from diffsep_tpu_torch.train.distill import progressive_distill

    stages = tuple(int(s) for s in args.stages.split(","))
    schedule = None if args.schedule == "none" else args.schedule
    dev = model.device
    ckpt = Path(args.teacher_ckpt) if args.teacher_ckpt else None
    if ckpt is not None and ckpt.exists():
        meta = load_teacher(model, ckpt, mismatch)
        teacher_time = float(meta.get("teacher_train_time_s", 0.0))
        log(f"teacher loaded from {ckpt} ({meta})")
    else:
        teacher_time = train_fn(model, ckpt)

    # the teacher first: progressive_distill leaves the last student's weights loaded
    result = {"teacher_steps": args.teacher_steps, "seed": args.seed, "teacher_train_time_s": round(teacher_time, 1),
              "distill_steps_per_stage": args.distill_steps, "stages": list(stages), "schedule": schedule, **head}
    ddim = {"predictor_name": "ddim", "corrector_name": "none", "schedule": schedule}
    score(result, "teacher_pc_n30", N=PC_N)
    teacher = {k: score(result, f"teacher_ddim_n{k}", N=k, **ddim) for k in sorted(set(stages))}
    log(json.dumps(result))

    trained = 0

    def counted(step):
        nonlocal trained
        trained += 1
        return batch_fn(step)

    _build.reset_counts()
    t0 = time.perf_counter()
    students = progressive_distill(model, counted, stages=stages, steps_per_stage=args.distill_steps,
                                   stage_cache_dir=args.stage_cache_dir, schedule=schedule, **distill_kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    distill_s = time.perf_counter() - t0
    launches, backward = dict(_build.launch_counts), dict(_build.backward_counts)
    result["distill_time_s"] = round(distill_s, 1)
    for k, state_dict in students.items():
        model.score_model.load_state_dict(state_dict, strict=True)
        log(f"stage N={k}: student {score(result, f'student_ddim_n{k}', N=k, **ddim)} vs teacher {teacher[k]}")

    def per_step(counts):
        return {key: v / trained for key, v in sorted(counts.items())} if trained else {}

    result.update(dtype=args.dtype, distill_steps_trained=trained,
                  s_per_distill_step=distill_s / trained if trained else None,
                  launches_per_distill_step=per_step(launches), backward_launches_per_distill_step=per_step(backward),
                  device=str(dev), card=card_name(dev))
    result.update(extra(result))
    if tiny:
        result["tiny"] = tiny
    print(json.dumps(result), flush=True)
    Path(args.out).write_text(json.dumps(result, indent=2))
    return result


def seed_path(path, seed):
    """``path`` with ``_seed{seed}`` before its suffix: seed S's file of a
    ``--seeds`` run."""
    path = Path(path)
    return path.with_name(f"{path.stem}_seed{seed}{path.suffix}")


def add_derived_deltas(rec):
    """dpmpp against ddim at each budget, and a distilled student against
    its teacher's ddim at its N, within one seed (a copy of
    scripts/seed_spread.py:add_derived_deltas)."""
    out = dict(rec)
    for n in SWEEP[1]:
        a, b = f"si_sdr_dpmpp_n{n}_db", f"si_sdr_ddim_n{n}_db"
        if a in rec and b in rec:
            out[f"si_sdr_delta_dpmpp_minus_ddim_n{n}_db"] = round(rec[a] - rec[b], 2)
    for n in (1, 2, 4, 8):
        a, b = f"si_sdr_student_ddim_n{n}_db", f"si_sdr_teacher_ddim_n{n}_db"
        if a in rec and b in rec:
            out[f"si_sdr_delta_distill_gain_n{n}_db"] = round(rec[a] - rec[b], 2)
    return out


def aggregate(records, keep_keys):
    """Per-key {mean, min, max, spread, values} over the seed records (a
    copy of scripts/seed_spread.py:aggregate). spread = max - min: with 3
    seeds a standard deviation would be noise on noise."""
    out = {"seeds": [r.get("seed") for r in records], "n_seeds": len(records)}
    keys = sorted(
        k
        for k in records[0]
        if keep_keys(k)
        and all(isinstance(r.get(k), (int, float)) for r in records)
    )
    for k in keys:
        vals = [float(r[k]) for r in records]
        out[k] = {
            "mean": round(sum(vals) / len(vals), 2),
            "min": round(min(vals), 2),
            "max": round(max(vals), 2),
            "spread": round(max(vals) - min(vals), 2),
            "values": [round(v, 2) for v in vals],
        }
    return out


def check_bar(records, bar=BAR):
    """Each metric of ``bar`` against the seed records: {metric: met}. A
    metric's bar is a least value for each seed (``each``) and for their
    mean (``mean``), or a value (0 unless given) to within ``abs``."""
    met = {}
    for key, b in bar.items():
        vals = [float(r[key]) for r in records]
        ok = True
        if "each" in b:
            ok &= min(vals) >= b["each"]
        if "mean" in b:
            ok &= sum(vals) / len(vals) >= b["mean"]
        if "abs" in b:
            ok &= max(abs(v - b.get("value", 0.0)) for v in vals) <= b["abs"] + 1e-9
        met[key] = bool(ok)
    return met


def spread_record(records, steps, bar=BAR, keep=lambda k: k.startswith("si_sdr_")):
    """The seeds' spread of every metric ``keep`` selects, with the run's
    card, speed and memory, and ``bar`` checked on the records."""
    records = [add_derived_deltas(r) for r in records]
    agg = aggregate(records, keep)
    agg["train_steps"] = steps
    agg["card"] = [r["card"] for r in records]
    agg["s_per_step"] = [r["s_per_step"] for r in records]
    agg["launches_per_step"] = records[0]["launches_per_step"]
    agg["peak_mem_gib"] = [r.get("peak_mem_gib") for r in records]
    agg["bar"] = bar
    agg["bar_met"] = check_bar(records, bar)
    return agg


def run_seeds(args, seeds, script=__file__, prefix="torch_port_train_demo", spread=spread_record, extra=None):
    """Every seed in a process of its own, all at once, running ``script``
    with the shared flags (and ``extra(seed)``'s); its records are
    DIR/{prefix}_seed{S}.json. Then the spread, ``spread(records, steps)``,
    as DIR/{prefix}_spread.json."""
    import torch

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cards = torch.cuda.device_count() if args.device is None else 0
    procs = []
    try:
        for i, seed in enumerate(seeds):
            out = out_dir / f"{prefix}_seed{seed}.json"
            cmd = [sys.executable, str(Path(script).resolve()), str(args.steps), "--seed", str(seed),
                   "--dtype", args.dtype, "--out", str(out)]
            cmd += ["--remat"] * args.remat + ["--tiny"] * args.tiny + (extra(seed) if extra else [])
            device = args.device or (f"cuda:{i % cards}" if cards > 1 else None)
            cmd += ["--device", device] if device else []
            procs.append((seed, out, subprocess.Popen(cmd)))
        failed = [seed for seed, _, p in procs if p.wait() != 0]
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise SystemExit(f"seeds {failed} failed")
    records = [json.loads(out.read_text()) for _, out, _ in procs]
    agg = spread(records, args.steps)
    (out_dir / f"{prefix}_spread.json").write_text(json.dumps(agg, indent=2))
    print(json.dumps(agg), flush=True)
    return agg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=2000)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--seed", type=int, default=0,
                    help="training seed: the data stream, the init and the step's draws; the held-out set "
                    "and the sampler's generator stay fixed")
    ap.add_argument("--seeds", default=None, help="comma-separated seeds, each run in a process of its own")
    ap.add_argument("--out", default="torch_port_train_demo_result.json", help="the record of one seed")
    ap.add_argument("--out-dir", default=str(Path(__file__).resolve().parent),
                    help="where --seeds writes its records")
    ap.add_argument("--save-ckpt", default=None,
                    help="write the trained EMA weights here (the port's weights file) and a provenance "
                    "sidecar beside it; with --seeds, each seed's with _seed{S} before the suffix")
    ap.add_argument("--device", default=None, help="cpu, cuda or cuda:N (default: the card)")
    ap.add_argument("--tiny", action="store_true", help="a CPU rehearsal at nf 8, batch 2 x 2000 samples")
    args = ap.parse_args(argv)
    if args.seeds:
        extra = (lambda s: ["--save-ckpt", str(seed_path(args.save_ckpt, s))]) if args.save_ckpt else None
        run_seeds(args, [int(s) for s in args.seeds.split(",")], extra=extra)
        return 0

    def log(msg):
        print(f"[seed {args.seed}] {msg}", flush=True)

    record, model, state = run_seed(args.steps, args.seed, args.dtype, args.remat, args.device, args.tiny, log)
    print(json.dumps(record), flush=True)
    Path(args.out).write_text(json.dumps(record, indent=2))
    if args.save_ckpt:
        save_teacher(args.save_ckpt, model, state, record)
        log(f"teacher saved to {args.save_ckpt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
