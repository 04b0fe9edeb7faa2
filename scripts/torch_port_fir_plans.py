#!/usr/bin/env python3
"""Times the bf16 FIR 2x kernels of the PyTorch port (diffsep_tpu_torch)
under every variant, at each FIR shape of one flagship score evaluation,
beside the kernel and wrapper of an earlier commit, on one GPU.

    python3 scripts/torch_port_fir_plans.py [--report PATH] [--parent DIR]

The shapes come from one flagship score evaluation (chip_smoke.SERVE_BATCH
mixtures of chip_smoke.SERVE_SECONDS s), as in chip_smoke.py. At each shape
these run: the plan of ops/fir_resample2x.plan_fir2x (marked `*`), "direct"
and "stream" with strips of 1 to 16 steps where the shape allows them, and
"tma" with tiles of 8, 16 and 32 columns, each with the planner's strip and
with half and twice it. The fastest is marked `+`. Each line is a device
time per call (chip_smoke.time_ms); then the earlier commit's kernel, and
the host's time to enqueue one call of the public function (fir_down2x or
fir_up2x) for the earlier wrapper and for this one, in the same process.

The earlier commit's ops/fir_resample2x.py and csrc/fir_resample2x.cu are
read from DIR (default build/kernels/fir_parent), which is filled with
`git show PARENT_REV:...` where it is empty; its kernel is built there with
nvcc and its wrapper is loaded with its `_build` replaced by one that binds
that library.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import FS, SERVE_BATCH, SERVE_SECONDS, sleep_cycles_per_ms, time_ms  # noqa: E402
from scripts.torch_port_conv_plans import host_us  # noqa: E402

PARENT_REV = "3dba2981b6f2868bd8188903d930be7ffd03ce59"  # the last commit with the first FIR kernel
PARENT_FILES = ("diffsep_tpu_torch/ops/fir_resample2x.py", "diffsep_tpu_torch/csrc/fir_resample2x.cu")
TAPS_DOWN = (0.125, 0.375, 0.375, 0.125)
TAPS_UP = (0.25, 0.75, 0.75, 0.25)


def load_parent(parent_dir: Path):
    """The earlier commit's wrapper module, bound to its own kernel."""
    from diffsep_tpu_torch.ops import _build

    parent_dir.mkdir(parents=True, exist_ok=True)
    for name in PARENT_FILES:
        dst = parent_dir / Path(name).name
        if not dst.exists():
            dst.write_bytes(subprocess.run(["git", "show", f"{PARENT_REV}:{name}"], cwd=ROOT, check=True,
                                           capture_output=True, timeout=60).stdout)
    lib_path = parent_dir / "libfir_parent.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(parent_dir / "fir_resample2x.cu")],
                   check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    entries = {}

    def entry(name, symbol, argtypes):  # as _build.entry, on the earlier library
        fn = entries.get((name, symbol))
        if fn is None:
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            entries[(name, symbol)] = fn
        return fn

    spec = importlib.util.spec_from_file_location("diffsep_tpu_torch.ops._fir_parent",
                                                  parent_dir / "fir_resample2x.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module._build = types.SimpleNamespace(entry=entry, check=_build.check, count_launch=_build.count_launch)
    return module


def candidates(fir, shape, up):
    """The planner's plan and the variants around it, bf16."""
    import torch

    b, h, w, c = shape
    steps, cols = (h, w) if up else (h // 2, w // 2)
    chosen = fir.plan_fir2x(b, h, w, c, torch.bfloat16, up)
    plans = {chosen}
    for rows in (1, 2, 4, 8, 16):
        if rows > max(1, steps):
            continue
        plans.add(fir._stream("direct", 1, b, steps, cols, c, rows))
        if c % 8 == 0:
            plans.add(fir._stream("stream", 8, b, steps, cols, c, rows))
    if c % fir.TMA_C == 0:
        for tw in (8, 16, 32):
            base = fir._tma(b, steps, cols, c, up, tw)
            for rows in {base.rows, max(1, base.rows // 2), min(steps, 2 * base.rows)}:
                plans.add(fir._tma(b, steps, cols, c, up, tw, rows))
    return chosen, sorted(plans, key=lambda p: (p.variant, p.cols, p.rows))


def main() -> int:
    import torch

    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.ops import _build
    from diffsep_tpu_torch.ops import fir_resample2x as fir

    ap = argparse.ArgumentParser()
    ap.add_argument("--report", type=Path, default=None, help="write every timing to this JSON file")
    ap.add_argument("--parent", type=Path, default=ROOT / "build" / "kernels" / "fir_parent",
                    help="directory holding (or to receive) the earlier commit's FIR sources")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_fir_plans: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    parent = load_parent(args.parent)
    dev = torch.device("cuda")
    model = DiffSepModel(device=dev, seed=0)
    n = SERVE_SECONDS * FS
    rng = np.random.default_rng(0)
    mix = torch.from_numpy((0.1 * rng.standard_normal((SERVE_BATCH, 1, n))).astype(np.float32)).to(dev)
    xt = torch.from_numpy((0.1 * rng.standard_normal((SERVE_BATCH, 2, n))).astype(np.float32)).to(dev)
    _build.reset_counts()
    with torch.no_grad():
        model.score_fn(xt, torch.full((SERVE_BATCH,), 0.5, device=dev), mix)
    shapes = sorted((k == "fir_up2x", s, cnt) for (k, s, _), cnt in _build.launch_shapes.items() if k.startswith("fir"))
    cycles_per_ms = sleep_cycles_per_ms()
    rows, per_eval = [], {"parent": 0.0, "chosen": 0.0, "fastest": 0.0}
    for up, shape, cnt in shapes:
        chosen, plans = candidates(fir, shape, up)
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        taps = TAPS_UP if up else TAPS_DOWN
        new_fn, old_fn = (fir.fir_up2x, parent.fir_up2x) if up else (fir.fir_down2x, parent.fir_down2x)
        want = old_fn(x, taps).float()
        tol = 1e-2 * max(1.0, want.abs().max().item())  # as chip_smoke.TOL for bf16
        times = {}
        for p in plans:
            assert (fir._launch(x, taps, up, p).float() - want).abs().max().item() <= tol, p
            times[p] = time_ms(lambda p=p: fir._launch(x, taps, up, p), cycles_per_ms)
        parent_ms = time_ms(lambda: old_fn(x, taps), cycles_per_ms)
        host = {"parent": host_us(lambda: old_fn(x, taps), cycles_per_ms),
                "new": host_us(lambda: new_fn(x, taps), cycles_per_ms)}
        host["parent again"] = host_us(lambda: old_fn(x, taps), cycles_per_ms)
        host["new again"] = host_us(lambda: new_fn(x, taps), cycles_per_ms)
        best = min(times, key=times.get)
        label = f"{'up' if up else 'down'} {'x'.join(map(str, shape))} x{cnt}"
        for p in plans:
            mark = ("*" if p == chosen else " ") + ("+" if p == best else " ")
            tile = f" x {p.cols:2d} cols, stages {p.stages}" if p.variant == "tma" else ""
            print(f"{mark} {label} {p.variant} strip {p.rows:2d}{tile} grid {p.grid}: {times[p]:.4f} ms", flush=True)
            rows.append(dict(shape=list(shape), up=up, launches_per_eval=cnt, variant=p.variant, rows=p.rows,
                             cols=p.cols, stages=p.stages, grid=list(p.grid), ms=times[p], chosen=p == chosen))
        print(f"   {label} earlier kernel: {parent_ms:.4f} ms; host enqueue us per call, earlier / this "
              f"wrapper: {host['parent']:.1f} / {host['new']:.1f}, again {host['parent again']:.1f} / "
              f"{host['new again']:.1f}", flush=True)
        rows.append(dict(shape=list(shape), up=up, launches_per_eval=cnt, variant="parent", ms=parent_ms,
                         host_us=host))
        per_eval["parent"] += cnt * parent_ms
        per_eval["chosen"] += cnt * times[chosen]
        per_eval["fastest"] += cnt * times[best]
    print(f"per flagship evaluation, ms: earlier kernel {per_eval['parent']:.4f}, planned {per_eval['chosen']:.4f}, "
          f"fastest of the candidates {per_eval['fastest']:.4f} ({card})", flush=True)
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(dict(card=card, per_eval_ms=per_eval, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
