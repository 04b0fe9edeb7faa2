#!/usr/bin/env python3
"""Times the bf16 conv3x3 kernels of the PyTorch port (diffsep_tpu_torch)
under every instantiated plan, at each conv shape of one flagship score
evaluation, on one GPU.

    python3 scripts/torch_port_conv_plans.py [--report PATH]

The shapes come from one flagship score evaluation (chip_smoke.SERVE_BATCH
mixtures of chip_smoke.SERVE_SECONDS s), as in chip_smoke.py. For each shape
that ops/conv3x3.plan_conv3x3 sends to a wgmma kernel (tma, wgmma,
tma_narrow or narrow), every instance of ops/conv3x3.INSTANCES of that variant and of
its sibling (tma and wgmma, tma_narrow and narrow) that fits runs: a wgmma
or narrow instance with the split count the planner would give its tile,
and with half and twice that.
Each line is a device time per call (chip_smoke.time_ms) and the host's
time to enqueue one call; the planner's choice is marked `*`, the fastest
`+`.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import FS, SERVE_BATCH, SERVE_SECONDS, sleep_cycles_per_ms, time_ms  # noqa: E402


def candidates(conv, shape, cout):
    """Every instantiated plan of the planner's variant and its sibling
    ("tma" and "wgmma", "tma_narrow" and "narrow") for this shape."""
    b, h, w, cin = shape
    m, k_tiles = b * h * w, 9 * cin // conv.SLICE
    chosen = conv.plan_conv3x3(b, h, w, cin, cout)
    siblings = [{"tma", "wgmma"}, {"tma_narrow", "narrow"}]
    variants = next((v for v in siblings if chosen.variant in v), set())  # none for generic
    plans = {chosen}
    for variant, bm, bn, stages in conv.INSTANCES:
        if variant not in variants or ("narrow" not in variant and cout % bn):
            continue
        if variant == "tma":
            plans.add(conv._tma(b, h, w, cout, k_tiles, bm, bn))
            continue
        if variant == "tma_narrow":
            plan = conv._tma_narrow(b, h, w, cout, k_tiles)
            if plan.smem_bytes <= conv.SMEM_LIMIT:
                plans.add(plan)
            continue
        base = conv._make(variant, m, cout, k_tiles, bm, bn, stages).splits
        for splits in {base, max(1, base // 2), min(k_tiles, 2 * base)}:
            grid = (-(-m // bm), -(-cout // bn), splits)
            smem = conv._smem_bytes(variant, bm, bn, stages, -(-k_tiles // splits))
            if smem <= conv.SMEM_LIMIT:
                plans.add(conv.ConvPlan(variant, bm, bn, stages, splits, grid, smem))
    return chosen, sorted(plans, key=lambda p: (p.variant, p.bm, p.bn, p.stages, p.splits))


def host_us(fn, cycles_per_ms, calls=50):
    """Host time to enqueue one call (the wrapper, its checks and the C
    entry point), median of 5 runs of `calls` calls queued behind a
    device-side sleep, so that the host never waits for the card."""
    import torch

    times = []
    for _ in range(5):
        torch.cuda._sleep(int(20 * cycles_per_ms))
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def main() -> int:
    import torch

    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.ops import _build
    from diffsep_tpu_torch.ops import conv3x3 as conv

    ap = argparse.ArgumentParser()
    ap.add_argument("--report", type=Path, default=None, help="write every timing to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_conv_plans: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    model = DiffSepModel(device=dev, seed=0)
    n = SERVE_SECONDS * FS
    rng = np.random.default_rng(0)
    mix = torch.from_numpy((0.1 * rng.standard_normal((SERVE_BATCH, 1, n))).astype(np.float32)).to(dev)
    xt = torch.from_numpy((0.1 * rng.standard_normal((SERVE_BATCH, 2, n))).astype(np.float32)).to(dev)
    _build.reset_counts()
    with torch.no_grad():
        model.score_fn(xt, torch.full((SERVE_BATCH,), 0.5, device=dev), mix)
    shapes = sorted({(s, c) for (k, s, c) in _build.launch_shapes if k == "conv3x3"})
    cycles_per_ms = sleep_cycles_per_ms()
    rows = []
    for shape, cout in shapes:
        chosen, plans = candidates(conv, shape, cout)
        if chosen.variant == "generic":
            continue
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        wt = (torch.randn((3, 3, shape[3], cout), generator=g, device=dev) / (9 * shape[3]) ** 0.5).to(torch.bfloat16)
        bias = torch.randn((cout,), generator=g, device=dev).to(torch.bfloat16)
        times = {p: time_ms(lambda p=p: conv._launch(x, wt, bias, p), cycles_per_ms) for p in plans}
        host = {p: host_us(lambda p=p: conv._launch(x, wt, bias, p), cycles_per_ms) for p in plans}
        best = min(times, key=times.get)
        for p in plans:
            mark = ("*" if p == chosen else " ") + ("+" if p == best else " ")
            print(f"{mark} {'x'.join(map(str, shape))}->{cout} {p.variant} {p.bm}x{p.bn} "
                  f"stages {p.stages} S {p.splits:3d} blocks {p.blocks:5d}: {times[p]:.4f} ms, "
                  f"host {host[p]:.1f} us", flush=True)
            rows.append(dict(shape=list(shape), cout=cout, variant=p.variant, bm=p.bm, bn=p.bn,
                             stages=p.stages, splits=p.splits, ms=times[p], host_us=host[p],
                             chosen=p == chosen))
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
