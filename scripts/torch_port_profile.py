#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port (diffsep_tpu_torch) on one GPU:
flagship score evaluations, or flagship training micro-steps.

    python3 scripts/torch_port_profile.py [--train] [--report PATH]

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

With --report it writes every kernel's row to PATH as JSON.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import FS, SERVE_BATCH, SERVE_SECONDS, TRAIN_BATCH  # noqa: E402

EVALS = 3
WARMUP, STEPS = 2, 4  # training micro-steps (an even count: whole optimizer steps)
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


def profile_eval(dev, card):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from diffsep_tpu_torch.model import DiffSepModel

    model = DiffSepModel(device=dev, seed=0)
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
        card=card, batch=SERVE_BATCH, seconds=SERVE_SECONDS, evals=EVALS,
        host_ms_per_eval=host_ms, device_busy_ms_per_eval=busy_ms,
        device_idle_share=1.0 - busy_ms / host_ms if host_ms else None,
        kernels=[dict(ms_per_eval=ms, launches_per_eval=c, name=name) for ms, c, name in kernels],
    )
    print(card)
    print(f"score evaluation, batch {SERVE_BATCH} x {SERVE_SECONDS} s: host {host_ms:.2f} ms, "
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


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--train", action="store_true", help="profile training micro-steps instead of evaluations")
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
    report = profile_train(dev, card) if args.train else profile_eval(dev, card)
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
