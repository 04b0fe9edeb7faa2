#!/usr/bin/env python3
"""Device-time breakdown of flagship score evaluations of the PyTorch port
(diffsep_tpu_torch) on one GPU.

    python3 scripts/torch_port_profile.py [--report PATH]

The flagship DiffSepModel (NCSN++ nf=128, bf16, seeded random weights)
evaluates its score on the smoke run's batch (chip_smoke.SERVE_BATCH
mixtures of chip_smoke.SERVE_SECONDS s at 8 kHz), EVALS times: first
unprofiled (host clock, ended by a synchronize), then under torch.profiler. It prints the device time per evaluation of each kernel
(top 25 by time), the device's busy time per evaluation, the host time per
evaluation and the device idle share (1 - busy / host time); with
--report it writes them, every kernel included, to PATH as JSON.
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

from chip_smoke import FS, SERVE_BATCH, SERVE_SECONDS  # noqa: E402

EVALS = 3


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from diffsep_tpu_torch.model import DiffSepModel

    ap = argparse.ArgumentParser()
    ap.add_argument("--report", type=Path, default=None, help="write the breakdown to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
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
    kernels = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            kernels.append((dev_us / 1e3 / EVALS, e.count / EVALS, e.key))
    kernels.sort(reverse=True)
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
    for ms, c, name in kernels[:25]:
        print(f"{ms:9.3f} ms {c:7.1f} x  {name[:110]}")
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
