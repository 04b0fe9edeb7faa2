#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (diffsep_tpu_torch) on one GPU.

    python3 chip_smoke.py [--report PATH]

Phases, each of which fails the run on any error:
  1. build the hand-written kernels of diffsep_tpu_torch/csrc with nvcc;
  2. find the kernel shapes of one flagship score evaluation (NCSN++
     nf=128, bf16, batch 2 x 5 s at 8 kHz) by running it once;
  3. kernel phase: every kernel at every one of those shapes, in float32
     and bfloat16, against its plain PyTorch version on the card, timed
     beside the plain version and one library call (cuDNN with TF32 off),
     each as the device time of back-to-back calls, with the plan that
     ops/conv3x3.plan_conv3x3 or ops/fir_resample2x.plan_fir2x chose;
  4. model phase: a small float32 model's score on the card (kernels)
     against the same score on the CPU (plain versions), with witnesses:
     the card on the plain versions, and both with a two-pass GroupNorm
     variance;
  5. serving phase: the flagship separates 2 mixtures of 5 s with
     reverse_diffusion + ald2 at N=30, then ddim + none at N=6; outputs
     must be finite and of shape (2, 2, 40000), and each kernel's launch
     count must be its per-evaluation count times the evaluations.

The last lines are the `{"kernels": [...]}` summary, then
`{"ok": true, "device": {...}}`. With --report, every result (per shape,
per dtype) is also written to PATH as JSON. It exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import itertools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM dense, tensor cores / CUDA cores
HBM_BYTES_PER_S = 3.35e12
SERVE_BATCH, SERVE_SECONDS, FS = 2, 5, 8000
PER_EVAL = {"conv3x3": 106, "fir_down2x": 18, "fir_up2x": 18}  # flagship NCSN++ launches per score evaluation
TOL = {"float32": 1e-4, "bfloat16": 1e-2}  # of max(1, max|plain|); see tests/test_torch_port_cuda.py
KERNELS = {
    "conv3x3": dict(source="diffsep_tpu_torch/csrc/conv3x3.cu",
                    replaces="diffsep_tpu/ops/pallas/conv3x3.py:75"),
    "fir_down2x": dict(source="diffsep_tpu_torch/csrc/fir_resample2x.cu",
                       replaces="diffsep_tpu/ops/pallas/upfirdn.py:94"),
    "fir_up2x": dict(source="diffsep_tpu_torch/csrc/fir_resample2x.cu",
                     replaces="diffsep_tpu/ops/pallas/upfirdn.py:130"),
}


def log(*args):
    print(*args, flush=True)


def sleep_cycles_per_ms():
    """Rate of torch.cuda._sleep, from one timed sleep."""
    import torch

    cycles = 10_000_000
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles // 10)  # let the clocks come up
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def time_ms(fn, cycles_per_ms):
    """Median device time of one call, over 5 repetitions. 3 to 20 calls,
    about 5 ms of work, are queued behind a device-side sleep that outlasts
    their enqueueing on the host, so they run back to back between one pair
    of CUDA events: the host's launch overhead stays out of the reading even
    where one call is shorter than its enqueueing."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    launches = max(3, min(20, int(5.0 / ((time.perf_counter() - t0) * 1e3))))
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_cycles = int(min(3 * enqueue_ms + 1.0, 100.0) * cycles_per_ms)
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def two_pass_group_norm(self, x):
    """layers.GroupNorm.forward with the variance taken as E[(x - E[x])^2]:
    the model phase's witness for the one-read formula's rounding."""
    import torch

    b, c, g = x.shape[0], x.shape[-1], self.num_groups
    xg = x.float().reshape(b, -1, g, c // g)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    a = torch.rsqrt(var + self.eps) * self.weight.float().reshape(g, c // g)
    shift = self.bias.float().reshape(g, c // g) - mean * a
    return (xg * a + shift).to(x.dtype).reshape(x.shape)


def randomize_(module, seed):
    """Unit-scale random weights for a parity check: the initializers'
    init_scale=0 layers would leave whole branches at ~1e-10."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(".W") and p.ndim == 1:
                continue  # Fourier projection keeps its init
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=g) / (p.numel() / p.shape[0]) ** 0.5)
            else:
                p.add_(0.1 * torch.randn(p.shape, generator=g))


def check_kernel(kind, shape, cout, dtype_name, dev, seed, cycles_per_ms):
    """Kernel vs plain on one shape: error, times, bound."""
    import torch
    import torch.nn.functional as F

    from diffsep_tpu_torch.ops import conv3x3 as conv_mod
    from diffsep_tpu_torch.ops import fir_resample2x as fir_mod

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    b, h, w, c = shape
    item = x.element_size()
    if kind == "conv3x3":
        wt = (torch.randn((3, 3, c, cout), generator=g, device=dev) / (9 * c) ** 0.5).to(dtype)
        bias = (0.1 * torch.randn((cout,), generator=g, device=dev)).to(dtype)
        w_lib = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        x_lib = x.permute(0, 3, 1, 2)  # NHWC data seen as channels_last NCHW

        def kern():
            return conv_mod.conv3x3(x, wt, bias)

        def plain():
            return conv_mod.conv3x3_plain(x, wt, bias)

        def library():
            return F.conv2d(x_lib, w_lib, bias, padding=1)

        flops = 2.0 * b * h * w * 9 * c * cout
        nbytes = (x.numel() + wt.numel() + b * h * w * cout + cout) * item
        p = conv_mod.plan_conv3x3(b, h, w, c, cout, dtype)
        plan = dict(variant=p.variant, bm=p.bm, bn=p.bn, stages=p.stages, splits=p.splits)
    else:
        up = kind == "fir_up2x"
        taps = (0.25, 0.75, 0.75, 0.25) if up else (0.125, 0.375, 0.375, 0.125)
        fn = fir_mod.fir_up2x if up else fir_mod.fir_down2x
        plain_fn = fir_mod.fir_up2x_plain if up else fir_mod.fir_down2x_plain
        f = torch.tensor(taps, device=dev)
        w_lib = torch.outer(f, f).expand(c, 1, 4, 4).contiguous(memory_format=torch.channels_last).to(dtype)
        x_lib = x.permute(0, 3, 1, 2)

        def kern():
            return fn(x, taps)

        def plain():
            return plain_fn(x, taps)

        if up:
            def library():
                return F.conv_transpose2d(x_lib, w_lib, stride=2, padding=1, groups=c)
        else:
            def library():
                return F.conv2d(x_lib, w_lib, stride=2, padding=1, groups=c)

        n_out = kern().numel()
        p = fir_mod.plan_fir2x(b, h, w, c, dtype, up)
        plan = dict(variant=p.variant, vec=p.vec, rows=p.rows, cols=p.cols, stages=p.stages, grid=list(p.grid))
        flops = (12.0 if up else 40.0) * n_out  # the kernel's multiply-adds x 2
        nbytes = (x.numel() + n_out) * item
    got, want, lib = kern(), plain(), library()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    lib_err = (got.float() - lib.permute(0, 2, 3, 1).float()).abs().max().item()
    peak = PEAK_FLOPS["float32"] if kind != "conv3x3" else PEAK_FLOPS[dtype_name]
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    ms, library_ms = time_ms(kern, cycles_per_ms), time_ms(library, cycles_per_ms)
    return dict(
        kernel=kind, shape=list(shape), cout=cout, dtype=dtype_name, plan=plan,
        max_abs_err=err, tol=TOL[dtype_name] * scale, ok=err <= TOL[dtype_name] * scale,
        library_abs_err=lib_err,
        ms=ms, plain_ms=time_ms(plain, cycles_per_ms), library_ms=library_ms,
        tflops=flops / ms / 1e9, ms_per_library_ms=ms / library_ms,
        bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
        ops_ms=t_ops, bytes_ms=t_bytes,
    )


def ptxas_lines(text):
    """nvcc's -Xptxas -v report, one instantiation at a time: its kernel (the
    mangled template arguments shortened) beside its register and spill lines."""
    entry = "?"
    for line in text.splitlines():
        found = re.search(r"entry function '[^']*?\d((?:conv3x3|fir)\w*?(?:kernel|reduce))(\w*)'", line)
        if found:
            args = found.group(2)
            entry = found.group(1) + (args[:args.find("Ev")] if args.startswith("I") else "")
        elif "registers" in line or "spill" in line:
            yield f"{entry}: {line.strip()}"


def plan_text(plan):
    if "splits" in plan:  # conv3x3
        return (f" plan {plan['variant']} {plan['bm']}x{plan['bn']} stages {plan['stages']} "
                f"S {plan['splits']}")
    tile = f" x {plan['cols']} cols, stages {plan['stages']}" if plan["variant"] == "tma" else ""
    return f" plan {plan['variant']} strip {plan['rows']}{tile}, grid {tuple(plan['grid'])}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--report", type=Path, default=None, help="write every result to this JSON file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    report = {"card": card}

    # 1. build
    t0 = time.perf_counter()
    ptxas = _build.build_all()
    for name in _build.KERNEL_SOURCES:
        _build.load(name)
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {report['build_s']:.1f} s for {', '.join(_build.KERNEL_SOURCES)}")
    for name, text in ptxas.items():
        for line in ptxas_lines(text):
            log(f"[build] {name}: {line}")

    # 2. shapes of one flagship score evaluation
    flagship = DiffSepModel(device=dev, seed=0)
    n = SERVE_SECONDS * FS
    rng = np.random.default_rng(0)
    mix = torch.from_numpy((0.1 * rng.standard_normal((SERVE_BATCH, 1, n))).astype(np.float32)).to(dev)
    xt = torch.from_numpy((0.1 * rng.standard_normal((SERVE_BATCH, 2, n))).astype(np.float32)).to(dev)
    _build.reset_counts()
    with torch.no_grad():
        probe = flagship.score_fn(xt, torch.full((SERVE_BATCH,), 0.5, device=dev), mix)
    torch.cuda.synchronize()
    shapes = dict(_build.launch_shapes)
    assert probe.shape == (SERVE_BATCH, 2, n) and torch.isfinite(probe).all()
    per_eval = collections.Counter()
    for (k, _, _), cnt in shapes.items():
        per_eval[k] += cnt
    log(f"[shapes] per score evaluation: {dict(per_eval)}; {len(shapes)} distinct kernel shapes")
    assert dict(per_eval) == PER_EVAL, dict(per_eval)

    # 3. kernel phase
    cycles_per_ms = sleep_cycles_per_ms()
    results = []
    for i, ((k, shape, cout), cnt) in enumerate(sorted(shapes.items(), key=str)):
        for dtype_name in ("float32", "bfloat16"):
            r = check_kernel(k, shape, cout, dtype_name, dev, i, cycles_per_ms)
            r["launches_per_eval"] = cnt
            results.append(r)
            log(f"[kernel] {k} {shape}->{cout} {dtype_name} x{cnt}:{plan_text(r['plan'])} "
                f"err {r['max_abs_err']:.3g} (tol {r['tol']:.3g}) ms {r['ms']:.4f} "
                f"plain {r['plain_ms']:.4f} lib {r['library_ms']:.4f} "
                f"ms/lib {r['ms_per_library_ms']:.3g} {r['tflops']:.1f} TFLOP/s "
                f"bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")
    report["kernel_checks"] = results
    bad = [r for r in results if not r["ok"]]
    assert not bad, f"kernel mismatches: {bad}"

    # 4. model phase: small f32 model, card vs CPU. Witnesses split the gap:
    # the card with every kernel replaced by its plain version (cuDNN with
    # TF32 off, plain FIR), and both with a two-pass GroupNorm variance, each
    # held against the CPU computing the same formula.
    from diffsep_tpu_torch.models import layers
    from diffsep_tpu_torch.ops import conv3x3 as conv_mod
    from diffsep_tpu_torch.ops import fir_resample2x as fir_mod

    small = {"score_model": {"backbone_args": {
        "nf": 32, "ch_mult": (1, 1, 2, 2), "num_res_blocks": 1, "dtype": "float32"}}}
    m_gpu = DiffSepModel(small, device=dev, seed=1)
    m_cpu = DiffSepModel(small, device="cpu", seed=1)
    randomize_(m_cpu.score_model, seed=2)
    m_gpu.score_model.load_state_dict(m_cpu.score_model.state_dict())
    xs = torch.from_numpy(rng.standard_normal((1, 2, FS)).astype(np.float32))
    ms_ = torch.from_numpy(rng.standard_normal((1, 1, FS)).astype(np.float32))
    ts = torch.tensor([0.4])
    scores, counts = {}, {}
    for route, gn in itertools.product(("kernels", "plain"), ("one-read", "two-pass")):
        with contextlib.ExitStack() as stack, torch.no_grad():
            if route == "plain":
                for mod, name in [(conv_mod, "conv3x3"), (fir_mod, "fir_down2x"), (fir_mod, "fir_up2x")]:
                    stack.enter_context(mock.patch.object(mod, name, getattr(mod, name + "_plain")))
            if gn == "two-pass":
                stack.enter_context(mock.patch.object(layers.GroupNorm, "forward", two_pass_group_norm))
            _build.reset_counts()
            scores[route, gn] = m_gpu.score_fn(xs.to(dev), ts.to(dev), ms_.to(dev)).cpu()
            counts[route, gn] = dict(_build.launch_counts)
            if route == "kernels":
                scores["cpu", gn] = m_cpu.score_fn(xs, ts, ms_)
    # the CPU's own rounding: each GroupNorm's one-read inverse std in f32
    # against the float64 one, relative
    gn_err = []

    def inv_std_err(mod, inp, out):
        xg = inp[0].float().reshape(inp[0].shape[0], -1, mod.num_groups, inp[0].shape[-1] // mod.num_groups)
        v32 = torch.clamp(xg.square().mean(dim=(1, 3)) - xg.mean(dim=(1, 3)).square(), min=0.0)
        v64 = xg.double().var(dim=(1, 3), unbiased=False)
        gn_err.append((((v64 + mod.eps) / (v32.double() + mod.eps)).sqrt() - 1).abs().max().item())

    hooks = [m.register_forward_hook(inv_std_err)
             for m in m_cpu.score_model.modules() if isinstance(m, layers.GroupNorm)]
    with torch.no_grad():
        m_cpu.score_fn(xs, ts, ms_)
    for h in hooks:
        h.remove()
    scale = scores["cpu", "one-read"].abs().max().item()

    def rel(a, b):
        return (scores[a] - scores[b]).abs().max().item() / scale

    model = {f"{r} {gn} vs cpu": rel((r, gn), ("cpu", gn))
             for r, gn in itertools.product(("kernels", "plain"), ("one-read", "two-pass"))}
    for gn in ("one-read", "two-pass"):
        model[f"kernels vs plain on the card, {gn}"] = rel(("kernels", gn), ("plain", gn))
    model["cpu two-pass vs one-read"] = rel(("cpu", "two-pass"), ("cpu", "one-read"))
    report["model_phase"] = dict(scale=scale, rel_err=model, launches=counts["kernels", "one-read"],
                                 cpu_inv_std_f32_vs_f64=gn_err)
    for name, v in model.items():
        log(f"[model] nf=32 f32 score, {name}: {v:.3g} of scale {scale:.3g}")
    log(f"[model] CPU one-read inverse std, f32 vs float64: first GroupNorm {gn_err[0]:.3g}, "
        f"max over {len(gn_err)} {max(gn_err):.3g}")
    log(f"[model] launches {counts['kernels', 'one-read']}; plain route {counts['plain', 'one-read']}")
    assert all(torch.isfinite(v).all() for v in scores.values())
    # The kernels' own share: they against the plain versions on the card,
    # same formula, read 3.4e-6 on an H100. The card-vs-CPU gap (6.1e-4) is
    # the same on the plain route; it comes from the f32 GroupNorm means
    # over 1.3e5 elements per group, which the one-read variance amplifies
    # (2.2e-4 with the two-pass variance), on either device.
    assert model["kernels vs plain on the card, one-read"] <= 2e-5
    assert model["kernels one-read vs cpu"] <= 1e-3
    assert all(counts["kernels", "one-read"].get(k, 0) > 0 for k in PER_EVAL), counts
    assert not counts["plain", "one-read"], counts

    # 5. serving phase
    serve = {}
    for label, kw in [
        ("reverse_diffusion+ald2 N=30", dict(N=30)),
        ("ddim+none N=6", dict(predictor_name="ddim", corrector_name="none", N=6)),
    ]:
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        t0 = time.perf_counter()
        est, nfe = flagship.separate(mix, generator=gen, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(_build.launch_counts)
        assert est.shape == (SERVE_BATCH, 2, n) and torch.isfinite(est).all(), label
        want = {k: v * nfe for k, v in PER_EVAL.items()}
        assert counts == want, (label, counts, want)
        serve[label] = dict(
            nfe=nfe, seconds=secs, utt_per_s=SERVE_BATCH / secs, launches=counts,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        )
        log(f"[serve] {label}: {SERVE_BATCH} x {SERVE_SECONDS} s in {secs:.2f} s = "
            f"{SERVE_BATCH / secs:.3f} utt/s, peak {serve[label]['peak_mem_gib']:.2f} GiB, "
            f"launches {counts} ({card})")
    report["serving"] = serve

    # summary per kernel: the bf16 (serving) times summed over one score
    # evaluation's launches at batch 2
    main_counts = serve["reverse_diffusion+ald2 N=30"]["launches"]
    summary = []
    for k, meta in KERNELS.items():
        rows = [r for r in results if r["kernel"] == k]
        bf = [r for r in rows if r["dtype"] == "bfloat16"]

        def per_eval_sum(key):
            return sum(r[key] * r["launches_per_eval"] for r in bf)

        summary.append(dict(
            name=k, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=main_counts[k], max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=per_eval_sum("ms"), plain_ms=per_eval_sum("plain_ms"),
            bound_ms=per_eval_sum("bound_ms"),
            bound_by="operations" if per_eval_sum("ops_ms") >= per_eval_sum("bytes_ms") else "bytes",
            library_ms=per_eval_sum("library_ms"),
        ))
    report["summary"] = summary
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
