#!/usr/bin/env python3
"""Times the conv3x3 kernels of the PyTorch port (diffsep_tpu_torch) under
every instantiated plan, at each conv shape of one flagship score
evaluation, on one GPU, in bf16 or in float32; or at the learning demo's
shapes.

    python3 scripts/torch_port_conv_plans.py [--dtype float32] [--report PATH]
    python3 scripts/torch_port_conv_plans.py --shapes demo [--report PATH]
    python3 scripts/torch_port_conv_plans.py --backward [--dtype float32|bfloat16] [--report PATH]

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

With --dtype float32 the shapes are those that take the "tf32x3" plan
(Cin % 32 == 0, Cout % 64 == 0), the flagship's and the 768-channel cat
inputs of the NCSN++ options, at batch 2 and at the f32 fallback recipe's
batch 6. Each runs the generic kernel, every "tf32x3" instance at the
planner's split count, half and twice that (and unsplit), and cuDNN in
float32 (TF32 off) twice: with torch.backends.cudnn.benchmark off (the
default heuristic's algorithm) and on (the fastest of cuDNN's algorithms,
chosen by its own timing on the first call).

With --shapes demo the shapes are those of one score evaluation of the
learning demo's NCSN++ (scripts/torch_port_train_demo.py: nf 32, ch_mult
(1, 1, 2), bf16) on 1 s mixtures at batch 16 (a training step) and 8 (its
evaluation). Each shape with Cin % 32 == 0 and Cin % 64 != 0 runs every
"slice32" instance that takes its Cout and fits, the generic kernel, and
cuDNN (`F.conv2d` on the channels-last views, TF32 off), beside its byte
bound and a copy of its input (`clone`: the rate HBM gives a plain
stream); each route's output is held to the exact sum (a float64 conv of
the same bf16 inputs: rms and largest error).

With --backward the shapes are the flagship's at the training batch of 6
(the f32 + remat recipe's micro-step), each with its launches in one score
evaluation (a micro-step's backward runs each conv's once; dx skips the
stem, whose input takes no gradient). In float32 each runs the port's dx
(``conv3x3_dx``: the forward kernel on the flipped weight) and dw
(``conv3x3_dw``), each held to its plain version (of max |plain|), and
cuDNN's ``convolution_backward`` for dx alone and dw alone: with
``cudnn.deterministic`` on (the recipe's ``trainer.deterministic=true``)
with TF32 off and on (torch's default for a user's run), and with it off,
TF32 off; beside each one's bound (chip_smoke.conv_bound_ms: that of
its plan, and in float32 also all at the FFMA peak and all as three TF32
products). The inputs, the cuDNN calls and the bounds are
chip_smoke.conv_bwd_case's, as phase 12 holds them. In bfloat16 each runs the hand forward
kernel on dy with the flipped weight (the dx a bf16 hand backward would
take; the port's bf16 backward is cuDNN's) against cuDNN's bf16 dx and
dw. Every time is also summed over the micro-step's launches, and in
float32 the dw per plan group (chip_smoke.bwd_group: "tf32x3", the
"window" output convs, the "window" stem) beside cuDNN's deterministic,
TF32-off dw and the bound on the same shapes.
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

from chip_smoke import (FS, HBM_BYTES_PER_S, PEAK_FLOPS, SERVE_BATCH, SERVE_SECONDS,  # noqa: E402
                        bwd_group, conv_bwd_case, sleep_cycles_per_ms, time_ms)


F32_EXTRA = [((2, 16, 20, 768), 256), ((2, 32, 40, 768), 256)]  # set C's cat inputs
DEMO_BATCHES = (16, 8)  # the learning demo's training and evaluation batches


def candidates(conv, shape, cout, dtype=None):
    """Every instantiated plan of the planner's variant and its sibling
    ("tma" and "wgmma", "tma_narrow" and "narrow") for this shape; for
    float32, every "tf32x3" instance; for "slice32", every instance that
    takes this Cout and fits; for float32 and "slice32", the generic kernel
    too."""
    import torch

    dtype = dtype or torch.bfloat16
    b, h, w, cin = shape
    slice_ = conv.F32_SLICE if dtype == torch.float32 else conv.SLICE
    m, k_tiles = b * h * w, 9 * cin // slice_
    chosen = conv.plan_conv3x3(b, h, w, cin, cout, dtype)
    siblings = [{"tma", "wgmma"}, {"tma_narrow", "narrow"}, {"tf32x3"}]
    variants = next((v for v in siblings if chosen.variant in v), set())  # none for generic
    plans = {chosen}
    if chosen.variant in ("tf32x3", "slice32"):
        plans.add(conv._generic(m, cout))
    if chosen.variant == "slice32":
        plans |= {p for v, bm, bn, _ in conv.INSTANCES if v == "slice32"
                  for p in [conv._c32(b, h, w, cin, cout, bm, bn)] if p is not None}
        return chosen, sorted(plans, key=lambda p: (p.variant, p.bm, p.bn, p.stages, p.splits))
    for variant, bm, bn, stages in conv.INSTANCES:
        if variant not in variants or ("narrow" not in variant and variant != "tf32x3" and cout % bn):
            continue
        if variant == "tf32x3" and (bn == 8) != (cout < 64) or cout >= 64 and cout % bn:
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
        for splits in {base, max(1, base // 2), min(k_tiles, 2 * base)} | ({1} if variant == "tf32x3" else set()):
            grid = (-(-m // bm), -(-cout // bn), splits)
            smem = conv._smem_bytes(variant, bm, bn, stages, -(-k_tiles // splits))
            if smem <= conv.SMEM_LIMIT:
                plans.add(conv.ConvPlan(variant, bm, bn, stages, splits, grid, smem))
    return chosen, sorted(plans, key=lambda p: (p.variant, p.bm, p.bn, p.stages, p.splits))


def conv_shapes(model, batch, n, dev):
    """The (shape, cout) of every conv3x3 call of one score evaluation of
    ``model`` on ``batch`` mixtures of ``n`` samples."""
    import torch

    from diffsep_tpu_torch.ops import _build

    rng = np.random.default_rng(0)
    mix = torch.from_numpy((0.1 * rng.standard_normal((batch, 1, n))).astype(np.float32)).to(dev)
    xt = torch.from_numpy((0.1 * rng.standard_normal((batch, 2, n))).astype(np.float32)).to(dev)
    _build.reset_counts()
    with torch.no_grad():
        model.score_fn(xt, torch.full((batch,), 0.5, device=dev), mix)
    return sorted({(s, c) for (k, s, c) in _build.launch_shapes if k == "conv3x3"})


def demo_shapes(dev):
    """The learning demo's conv shapes at its training and evaluation batches."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_port_train_demo", ROOT / "scripts" / "torch_port_train_demo.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    model = demo.build_model("bfloat16", False, dev, seed=0)
    return sorted({sc for b in DEMO_BATCHES for sc in conv_shapes(model, b, demo.SAMPLES, dev)})


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


BACKWARD_BATCH = 6  # the recipe's batch: chip_smoke.TRAIN_BATCH


def conv_launches(model, batch, n, dev):
    """{(shape, cout): launches} of one score evaluation of ``model``."""
    import torch

    from diffsep_tpu_torch.ops import _build

    rng = np.random.default_rng(0)
    mix = torch.from_numpy((0.1 * rng.standard_normal((batch, 1, n))).astype(np.float32)).to(dev)
    xt = torch.from_numpy((0.1 * rng.standard_normal((batch, 2, n))).astype(np.float32)).to(dev)
    _build.reset_counts()
    with torch.no_grad():
        model.score_fn(xt, torch.full((batch,), 0.5, device=dev), mix)
    return {(s, c): k for (name, s, c), k in _build.launch_shapes.items() if name == "conv3x3"}


def backward_main(args, card, dev) -> int:
    """--backward: see the module docstring."""
    import torch

    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.ops import conv3x3 as conv

    dtype = getattr(torch, args.dtype)
    f32 = dtype == torch.float32
    model = DiffSepModel({"score_model": {"backbone_args": {"dtype": args.dtype}}}, device=dev, seed=0)
    launches = conv_launches(model, BACKWARD_BATCH, SERVE_SECONDS * FS, dev)
    stem = min(launches, key=lambda sc: sc[0][3])  # Cin 6: no dx
    del model
    torch.cuda.empty_cache()
    cycles_per_ms = sleep_cycles_per_ms()
    cudnn_cases = ([("deterministic, TF32 off", True, False), ("deterministic, TF32 on", True, True),
                    ("TF32 off", False, False)] if f32 else [("bf16", False, False)])
    rows, totals = [], {}
    for (shape, cout), n in sorted(launches.items()):
        case = conv_bwd_case(shape, cout, args.dtype, dev, 0)
        x, wt, dy = case.x, case.wt, case.dy
        n_dx = 0 if (shape, cout) == stem else n
        row = dict(shape=list(shape), cout=cout, dtype=args.dtype, launches_dx=n_dx, launches_dw=n,
                   plan_dx=case.plans["dx"].variant)
        for part, bound in case.bounds.items():
            row.update({f"{key[:-3]}_{part}_ms": bound[key] for key in ("bound_ms", "bound_ffma_ms", "bound_3xtf32_ms")
                        if key in bound})
        if f32:
            dx_fn, dw_fn = (lambda: conv.conv3x3_dx(dy, wt)), (lambda: conv.conv3x3_dw(x, dy))
            want_dx, want_dw = conv.conv3x3_dx_plain(dy, wt), conv.conv3x3_dw_plain(x, dy)
            row.update(plan_dw=case.plans["dw"].variant,
                       group_dw=bwd_group(dict(plan=dict(variant=case.plans["dw"].variant), shape=shape, cout=cout)),
                       err_dw=((dw_fn() - want_dw).abs().max() / want_dw.abs().max()).item())
        else:
            wflip = conv.conv3x3_dx_weight(wt)
            dx_fn = lambda: conv.conv3x3(dy, wflip)  # noqa: E731
            want_dx = conv.conv3x3_plain(dy, wflip)
        row["err_dx"] = ((dx_fn().float() - want_dx.float()).abs().max() / want_dx.float().abs().max()).item()
        with torch.no_grad():
            row["hand_dx_ms"] = time_ms(dx_fn, cycles_per_ms)
            if f32:
                row["hand_dw_ms"] = time_ms(dw_fn, cycles_per_ms)
        for label, det, tf32 in cudnn_cases:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = det, tf32
            try:
                for part in ("dx", "dw"):
                    row[f"cudnn {label} {part}_ms"] = time_ms(lambda part=part: case.library(part), cycles_per_ms)
            finally:
                torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = False, False
        rows.append(row)
        for key, v in row.items():
            if key.endswith("_ms"):
                per = row["launches_dx"] if "dx" in key else row["launches_dw"]
                totals[key] = totals.get(key, 0.0) + v * per
        print(f"{'x'.join(map(str, shape))}->{cout} x{n} ({n_dx} dx): "
              + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in row.items()
                          if k not in ("shape", "cout", "dtype", "launches_dx", "launches_dw")), flush=True)
    print(f"per micro-step at batch {BACKWARD_BATCH} ({sum(r['launches_dx'] for r in rows)} dx, "
          f"{sum(r['launches_dw'] for r in rows)} dw; {card}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in totals.items()), flush=True)
    groups = {}  # dw per plan group, beside cuDNN's deterministic, TF32-off dw on the same shapes
    for r in rows if f32 else []:
        g = groups.setdefault(r["group_dw"], dict(launches=0, hand_dw_ms=0.0, cudnn_dw_ms=0.0, bound_dw_ms=0.0))
        g["launches"] += r["launches_dw"]
        for key, src in (("hand_dw_ms", "hand_dw_ms"), ("cudnn_dw_ms", "cudnn deterministic, TF32 off dw_ms"),
                         ("bound_dw_ms", "bound_dw_ms")):
            g[key] += r[src] * r["launches_dw"]
    for name, g in sorted(groups.items()):
        print(f"dw {name} x{g['launches']}: hand {g['hand_dw_ms']:.3f} ms, cuDNN deterministic TF32 off "
              f"{g['cudnn_dw_ms']:.3f}, bound {g['bound_dw_ms']:.3f} ({card})", flush=True)
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(dict(card=card, rows=rows, per_micro_step=totals, dw_by_group=groups),
                                          indent=1))
    return 0


def main() -> int:
    import torch
    import torch.nn.functional as F

    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.ops import conv3x3 as conv

    ap = argparse.ArgumentParser()
    ap.add_argument("--report", type=Path, default=None, help="write every timing to this JSON file")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--shapes", choices=("flagship", "demo"), default="flagship",
                    help="the flagship's conv shapes, or the learning demo's at batch 16 and 8 (bf16)")
    ap.add_argument("--backward", action="store_true",
                    help="time the conv's backward (dx, dw) at the flagship's shapes at batch 6 against cuDNN's")
    args = ap.parse_args()
    if args.shapes == "demo" and args.dtype != "bfloat16":
        ap.error("--shapes demo times bf16")
    if args.backward and args.shapes == "demo":
        ap.error("--backward times the flagship's shapes")
    if not torch.cuda.is_available():
        print("torch_port_conv_plans: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    if args.backward:
        return backward_main(args, card, dev)
    if args.shapes == "demo":  # the shapes of the 32-channel-slice plans
        shapes = [(sh, c) for sh, c in demo_shapes(dev) if sh[3] % conv.C32 == 0 and sh[3] % conv.SLICE]
    else:
        shapes = conv_shapes(DiffSepModel(device=dev, seed=0), SERVE_BATCH, SERVE_SECONDS * FS, dev)
    dtype = getattr(torch, args.dtype)
    if dtype == torch.float32:
        shapes = sorted({((bb, *s[1:]), c) for s, c in shapes + F32_EXTRA for bb in (SERVE_BATCH, 6)})
    torch.backends.cudnn.allow_tf32 = False
    cycles_per_ms = sleep_cycles_per_ms()
    rows = []
    for shape, cout in shapes:
        chosen, plans = candidates(conv, shape, cout, dtype)
        if chosen.variant == "generic":
            continue
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        wt = (torch.randn((3, 3, shape[3], cout), generator=g, device=dev) / (9 * shape[3]) ** 0.5).to(dtype)
        bias = torch.randn((cout,), generator=g, device=dev).to(dtype)
        with torch.no_grad():  # the tf32x3 plans' split weight is made once, as when serving
            want = conv.conv3x3_plain(x, wt, bias).float()
            scale = max(1.0, want.abs().max().item())
            errs = {p: (conv._launch(x, wt, bias, p).float() - want).abs().max().item() / scale for p in plans}
            times = {p: time_ms(lambda p=p: conv._launch(x, wt, bias, p), cycles_per_ms) for p in plans}
            host = {p: host_us(lambda p=p: conv._launch(x, wt, bias, p), cycles_per_ms) for p in plans}
        best = min(times, key=times.get)
        for p in plans:
            mark = ("*" if p == chosen else " ") + ("+" if p == best else " ")
            print(f"{mark} {'x'.join(map(str, shape))}->{cout} {p.variant} {p.bm}x{p.bn} "
                  f"stages {p.stages} S {p.splits:3d} blocks {p.blocks:5d}: {times[p]:.4f} ms, "
                  f"host {host[p]:.1f} us, err {errs[p]:.3g} of scale", flush=True)
            rows.append(dict(shape=list(shape), cout=cout, dtype=args.dtype, variant=p.variant, bm=p.bm, bn=p.bn,
                             stages=p.stages, splits=p.splits, ms=times[p], host_us=host[p], rel_err=errs[p],
                             chosen=p == chosen))
        if chosen.variant == "slice32":
            x_lib = x.permute(0, 3, 1, 2)
            w_lib = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            ms = time_ms(lambda: F.conv2d(x_lib, w_lib, bias, padding=1), cycles_per_ms)
            copy_ms = time_ms(lambda: x.clone(), cycles_per_ms)
            nbytes = (x.numel() + wt.numel() + x.numel() // shape[3] * cout + cout) * 2
            bound = max(nbytes / HBM_BYTES_PER_S, 2.0 * x.numel() * 9 * cout / PEAK_FLOPS["bfloat16"]) * 1e3
            with torch.no_grad():
                exact = F.conv2d(x_lib.double(), w_lib.double(), bias.double(), padding=1).permute(0, 2, 3, 1)
                outs = {f"{p.variant} {p.bm}x{p.bn}": conv._launch(x, wt, bias, p) for p in plans}
                outs["cudnn"] = F.conv2d(x_lib, w_lib, bias, padding=1).permute(0, 2, 3, 1)
                exact_err = {k: dict(rms=(v.double() - exact).pow(2).mean().sqrt().item(),
                                     max=(v.double() - exact).abs().max().item()) for k, v in outs.items()}
            print(f"   {'x'.join(map(str, shape))}->{cout} cudnn: {ms:.4f} ms; copy of x {copy_ms:.4f} ms; "
                  f"bound {bound * 1e3:.3f} us; error against the exact sum "
                  + ", ".join(f"{k} rms {e['rms']:.4g} max {e['max']:.4g}" for k, e in exact_err.items()),
                  flush=True)
            rows.append(dict(shape=list(shape), cout=cout, dtype=args.dtype, variant="cudnn", ms=ms, bound_ms=bound,
                             copy_ms=copy_ms, exact_err=exact_err))
        if dtype == torch.float32:
            x_lib = x.permute(0, 3, 1, 2)
            w_lib = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            for tuned in (False, True):
                torch.backends.cudnn.benchmark = tuned
                ms = time_ms(lambda: F.conv2d(x_lib, w_lib, bias, padding=1), cycles_per_ms)
                label = "cudnn f32 benchmark" if tuned else "cudnn f32 heuristic"
                print(f"   {'x'.join(map(str, shape))}->{cout} {label}: {ms:.4f} ms", flush=True)
                rows.append(dict(shape=list(shape), cout=cout, dtype=args.dtype, variant=label, ms=ms))
            torch.backends.cudnn.benchmark = False
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
