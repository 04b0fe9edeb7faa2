#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port (diffsep_tpu_torch) on one GPU:
flagship score evaluations, or flagship training micro-steps.

    python3 scripts/torch_port_profile.py [--train | --serve | --diffuse] [--report PATH]

Without --train, the flagship DiffSepModel (NCSN++ nf=128, bf16, seeded
random weights) evaluates its score on the smoke run's batch
(chip_smoke.SERVE_BATCH mixtures of chip_smoke.SERVE_SECONDS s at 8 kHz),
EVALS times: first unprofiled (host clock, ended by a synchronize), then
under torch.profiler. It prints the device time per evaluation of each
kernel (top 25 by time), the device's busy time per evaluation, the host
time per evaluation and the device idle share (1 - busy / host time).

With --train, the ICASSP separation recipe (composed as
``experiment=icassp-separation``: the flagship with Adam, fixed clipping,
EMA, accumulation over 2 micro-batches, init hack 5) takes micro-steps of
batch chip_smoke.TRAIN_BATCH x 5 s through its train step: WARMUP steps,
then STEPS timed on the host clock (ended by a synchronize), then STEPS
under torch.profiler. Device time per micro-step is given by kernel for the
whole step, and apart for the loss's forward and for its backward, each
profiled on its own (a forward, a synchronize, then the backward), so the
hand kernels' forward and backward launches and cuDNN's conv backward show
apart; the rest of a step is clipping, the optimizer and the EMA. It also
gives the host's time to enqueue the forward and the backward, each from an
idle card, and the host's time by op.

With --serve, the serving engine (``cli.serve.SeparationEngine`` over the
flagship, batch chip_smoke.HTTP_BATCH, 1 s buckets, reverse_diffusion +
ald2 at N=chip_smoke.PROD_N) runs SERVE_RUNS micro-batches of 4-5 s
requests through its depth-1 pipeline (micro-batch k+1 dispatched before k
is finalized), first unprofiled (host clock), then under torch.profiler.
It prints, per micro-batch, the host time in the dispatch and in the
finalize, whether the card was still busy when the dispatch returned, and
the calls inside each dispatch and each finalize that wait on the card
(stream, device and event synchronizes, blocking copies, scalar reads): a
dispatch that waits keeps micro-batch k+1's enqueueing from overlapping
k's device time, and a finalize must wait (its copy to the host). It also
gives the device's busy time per micro-batch against the host's
(unprofiled), and the idle share 1 - busy / host.

With --diffuse, the evaluations are those of the DiffuSE recipe's model
instead (``model=diffuse``: 30 layers x 64 channels, float32, seeded random
weights), on the same batch.

With --report it writes every kernel's row to PATH as JSON.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import FS, HTTP_BATCH, PROD_N, SERVE_BATCH, SERVE_SECONDS, TRAIN_BATCH  # noqa: E402

EVALS = 3
WARMUP, STEPS = 2, 4  # training micro-steps (an even count: whole optimizer steps)
SERVE_RUNS = 3  # pipelined serving micro-batches
# host calls that wait on the card (torch.profiler's names)
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
         "aten::_local_scalar_dense")
# kernel name fragments of the groups the training breakdown sums
GROUPS = (("hand conv3x3", ("conv3x3",)), ("hand FIR", ("fir2x",)), ("cuDNN conv backward", ("dgrad", "wgrad")))


def device_kernels(prof, per):
    """[(device ms per unit, launches per unit, kernel name)] of a profile,
    largest first; ``per`` units were profiled."""
    import torch

    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us / 1e3 / per, e.count / per, e.key))
    return sorted(rows, reverse=True)


def host_ops(prof, per, top=15):
    """[(host ms per unit, calls per unit, op)] of the CPU side, by self
    time, largest first: where the host's time goes (Python-side aten ops,
    the CUDA runtime's launch and copy calls)."""
    import torch

    rows = [(e.self_cpu_time_total / 1e3 / per, e.count / per, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU and e.self_cpu_time_total > 0]
    return sorted(rows, reverse=True)[:top]


def grouped(rows):
    """Device ms per unit of each of GROUPS, and of the rest."""
    out = {name: 0.0 for name, _ in GROUPS}
    out["other"] = 0.0
    for ms, _, name in rows:
        group = next((g for g, frags in GROUPS if any(f in name for f in frags)), "other")
        out[group] += ms
    return out


def print_rows(rows, unit, top=25):
    for ms, c, name in rows[:top]:
        print(f"{ms:9.3f} ms {c:7.1f} x / {unit}  {name[:110]}")


def profile_eval(dev, card, diffuse=False):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from diffsep_tpu_torch.config import compose
    from diffsep_tpu_torch.model import DiffSepModel

    model = DiffSepModel(compose(["model=diffuse"]) if diffuse else None, device=dev, seed=0)
    n = SERVE_SECONDS * FS
    rng = np.random.default_rng(0)
    mix = torch.from_numpy((0.1 * rng.standard_normal((SERVE_BATCH, 1, n))).astype(np.float32)).to(dev)
    xt = torch.from_numpy((0.1 * rng.standard_normal((SERVE_BATCH, 2, n))).astype(np.float32)).to(dev)
    t = torch.full((SERVE_BATCH,), 0.5, device=dev)

    def run():
        with torch.no_grad():
            for _ in range(EVALS):
                model.score_fn(xt, t, mix)
        torch.cuda.synchronize()

    run()  # warm-up: kernel build and load, cuBLAS handles, caching allocator
    t0 = time.perf_counter()
    run()
    host_ms = (time.perf_counter() - t0) * 1e3 / EVALS

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    kernels = device_kernels(prof, EVALS)
    busy_ms = sum(k[0] for k in kernels)
    report = dict(
        card=card, model="diffuse" if diffuse else "flagship", batch=SERVE_BATCH, seconds=SERVE_SECONDS, evals=EVALS,
        host_ms_per_eval=host_ms, device_busy_ms_per_eval=busy_ms,
        device_idle_share=1.0 - busy_ms / host_ms if host_ms else None,
        kernels=[dict(ms_per_eval=ms, launches_per_eval=c, name=name) for ms, c, name in kernels],
    )
    print(card)
    print(f"{report['model']} score evaluation, batch {SERVE_BATCH} x {SERVE_SECONDS} s: host {host_ms:.2f} ms, "
          f"device busy {busy_ms:.2f} ms, idle share {report['device_idle_share']:.3f}")
    print_rows(kernels, "eval")
    return report


def profile_train(dev, card):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from diffsep_tpu_torch.config import compose
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.train.losses import Draws
    from diffsep_tpu_torch.train.trainer import make_loss_fn, step_generator

    model = DiffSepModel(compose(["experiment=icassp-separation"]), device=dev, seed=0)
    state = model.init_state()
    train_step = model.make_train_step(seed=0)
    loss_fn = make_loss_fn(model.score_model, model.sde, model.loss_cfg)
    n = SERVE_SECONDS * FS
    rng = np.random.default_rng(0)
    tgt = torch.from_numpy((0.1 * rng.standard_normal((TRAIN_BATCH, 2, n))).astype(np.float32)).to(dev)
    mix = tgt.sum(dim=1, keepdim=True)

    def steps(count):
        for _ in range(count):
            train_step(state, mix, tgt)
        torch.cuda.synchronize()

    steps(WARMUP)  # kernel build and load, cuDNN's algorithm search, allocator
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    steps(STEPS)
    host_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        steps(STEPS)
    whole = device_kernels(prof, STEPS)

    # host time to enqueue the loss's forward and its backward, each from an
    # idle card, unprofiled
    enqueue = {"forward": [], "backward": []}
    for i in range(STEPS):
        model.score_model.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        loss = loss_fn(Draws(step_generator(0, 100 + i, dev)), mix, tgt)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loss.backward()
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue["forward"].append((t1 - t0) * 1e3)
        enqueue["backward"].append((t3 - t2) * 1e3)

    # the loss's forward and its backward, each profiled on its own
    fwd, bwd = [], []
    for i in range(STEPS):
        model.score_model.zero_grad(set_to_none=True)
        with profile(activities=acts) as p_fwd:
            loss = loss_fn(Draws(step_generator(0, 100 + i, dev)), mix, tgt)
            torch.cuda.synchronize()
        with profile(activities=acts) as p_bwd:
            loss.backward()
            torch.cuda.synchronize()
        fwd.append(device_kernels(p_fwd, 1))
        bwd.append(device_kernels(p_bwd, 1))
    model.score_model.zero_grad(set_to_none=True)

    def mean_rows(runs):
        acc = {}
        for rows in runs:
            for ms, c, name in rows:
                a = acc.setdefault(name, [0.0, 0.0])
                a[0] += ms / len(runs)
                a[1] += c / len(runs)
        return sorted(((ms, c, name) for name, (ms, c) in acc.items()), reverse=True)

    fwd, bwd = mean_rows(fwd), mean_rows(bwd)
    busy = sum(k[0] for k in whole)
    host = host_ops(prof, STEPS)
    report = dict(
        card=card, batch=TRAIN_BATCH, seconds=SERVE_SECONDS, steps=STEPS,
        host_ms_per_micro_step=host_ms, device_busy_ms_per_micro_step=busy,
        device_idle_share=1.0 - busy / host_ms, peak_gib=peak_gib,
        forward_busy_ms=sum(k[0] for k in fwd), backward_busy_ms=sum(k[0] for k in bwd),
        host_enqueue_ms={k: float(np.median(v)) for k, v in enqueue.items()},
        host_ops=[dict(ms_per_micro_step=ms, calls_per_micro_step=c, name=name) for ms, c, name in host],
        groups={"micro-step": grouped(whole), "forward": grouped(fwd), "backward": grouped(bwd)},
        kernels={part: [dict(ms_per_micro_step=ms, launches_per_micro_step=c, name=name) for ms, c, name in rows]
                 for part, rows in (("micro-step", whole), ("forward", fwd), ("backward", bwd))},
    )
    print(card)
    print(f"training micro-step, batch {TRAIN_BATCH} x {SERVE_SECONDS} s: host {host_ms:.2f} ms, "
          f"device busy {busy:.2f} ms, idle share {report['device_idle_share']:.3f}, "
          f"peak {peak_gib:.2f} GiB; forward busy {report['forward_busy_ms']:.2f} ms, "
          f"backward busy {report['backward_busy_ms']:.2f} ms")
    print(f"host enqueue from an idle card, median of {STEPS}: forward "
          f"{report['host_enqueue_ms']['forward']:.2f} ms, backward {report['host_enqueue_ms']['backward']:.2f} ms")
    print("host, top ops by self time per micro-step (profiled): " + "; ".join(
        f"{name} {ms:.2f} ms x{c:.0f}" for ms, c, name in host))
    for part, groups in report["groups"].items():
        print(f"{part}: " + ", ".join(f"{g} {ms:.3f} ms" for g, ms in groups.items()))
    for part, rows in (("forward", fwd), ("backward", bwd), ("micro-step", whole)):
        print(f"--- {part}, top kernels")
        print_rows(rows, "step", top=15 if part != "micro-step" else 25)
    return report


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile_serve(dev, card):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from diffsep_tpu_torch.cli.serve import SeparationEngine
    from diffsep_tpu_torch.model import DiffSepModel

    model = DiffSepModel(device=dev, seed=0)
    engine = SeparationEngine(model, batch=HTTP_BATCH, bucket_s=1.0, sampler_kwargs={"N": PROD_N})
    rng = np.random.default_rng(0)
    mixes = [(0.1 * rng.standard_normal((1, SERVE_SECONDS * FS - int(rng.integers(0, FS))))).astype(np.float32)
             for _ in range(HTTP_BATCH * SERVE_RUNS)]  # one bucket: SERVE_RUNS micro-batches
    engine._run_bucket(mixes[:HTTP_BATCH])  # warm-up: kernel build and load, allocator
    torch.cuda.synchronize()

    # the engine's own pipeline, its two steps timed and marked for the trace
    dispatch, finalize, runs = engine._dispatch_bucket, engine._finalize_bucket, []

    def timed_dispatch(rows):
        t0 = time.perf_counter()
        with record_function(f"dispatch {len(runs)}"):
            handle = dispatch(rows)
        runs.append(dict(dispatch_ms=(time.perf_counter() - t0) * 1e3,
                         card_busy=not torch.cuda.current_stream(dev).query()))
        return handle, len(runs) - 1

    def timed_finalize(handle):
        handle, k = handle
        t0 = time.perf_counter()
        with record_function(f"finalize {k}"):
            out = finalize(handle)
        runs[k]["finalize_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    engine._dispatch_bucket, engine._finalize_bucket = timed_dispatch, timed_finalize

    def pipeline():
        """Per micro-batch: host ms in the dispatch, the card busy at its
        return, host ms in the finalize."""
        runs.clear()
        for _, _, err, *_ in engine.pipeline(mixes, lambda m: m):
            if err is not None:
                raise err
        return list(runs)

    t0 = time.perf_counter()
    runs_unprofiled = pipeline()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prof_runs = pipeline()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    events = list(prof.events())
    cuda = torch.autograd.DeviceType.CUDA

    def annotation(name):  # the ranges above, which the profiler mirrors on the device's timeline
        return name.split(" ")[0] in ("dispatch", "finalize")

    # the finalizes copy to the host, so they must wait: they show that the
    # waits are seen
    ranges = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                    if e.device_type != cuda and annotation(e.name))
    waits = {name: collections.Counter() for *_, name in ranges}
    for e in events:
        if e.device_type != cuda and e.name in WAITS:
            for a, b, name in ranges:
                if a <= e.time_range.start <= b:
                    waits[name][e.name] += 1
    busy_ms = busy_us([(e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == cuda and not annotation(e.name)]) / 1e3 / SERVE_RUNS
    host_ms = wall_ms / SERVE_RUNS
    kernels = [row for row in device_kernels(prof, SERVE_RUNS) if not annotation(row[2])]
    report = dict(
        card=card, batch=HTTP_BATCH, bucket_s=SERVE_SECONDS, N=PROD_N, runs=SERVE_RUNS,
        host_ms_per_run=host_ms, device_busy_ms_per_run=busy_ms, device_idle_share=1.0 - busy_ms / host_ms,
        launches_per_run=sum(c for _, c, _ in kernels), runs_unprofiled=runs_unprofiled, runs_profiled=prof_runs,
        profiled_wall_ms=prof_wall_ms, waits={name: dict(c) for name, c in waits.items()},
        kernels=[dict(ms_per_run=ms, launches_per_run=c, name=name) for ms, c, name in kernels],
    )
    print(card)
    print(f"serving pipeline, {SERVE_RUNS} micro-batches of {HTTP_BATCH} x 4-5 s (the {SERVE_SECONDS} s bucket), "
          f"reverse_diffusion+ald2 N={PROD_N}, per micro-batch: host {host_ms:.1f} ms (unprofiled), device busy "
          f"{busy_ms:.1f} ms, idle share {report['device_idle_share']:.3f}, "
          f"{report['launches_per_run']:.0f} device launches")
    for label, rows in (("unprofiled", runs_unprofiled), ("profiled", prof_runs)):
        for k, r in enumerate(rows):
            print(f"{label} run {k}: dispatch {r['dispatch_ms']:.1f} ms (card {'busy' if r['card_busy'] else 'idle'} "
                  f"at its return), finalize {r['finalize_ms']:.1f} ms")
    for name, c in waits.items():
        print(f"{name}: calls that wait on the card: {dict(c) or 'none'}")
    print_rows(kernels, "run", top=15)
    return report


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true", help="profile training micro-steps instead of evaluations")
    mode.add_argument("--serve", action="store_true", help="profile the serving engine's pipeline instead")
    mode.add_argument("--diffuse", action="store_true", help="profile evaluations of the model=diffuse model")
    ap.add_argument("--report", type=Path, default=None, help="write the breakdown to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_profile: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    if args.train or args.serve:
        report = (profile_train if args.train else profile_serve)(dev, card)
    else:
        report = profile_eval(dev, card, diffuse=args.diffuse)
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
