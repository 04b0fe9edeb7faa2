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
     count must be its per-evaluation count times the evaluations;
  6. training phase: the ICASSP separation recipe (nf=128, bf16, batch 6 x
     5 s, accumulate 2, init hack 5) trains through the entry point
     (diffsep_tpu_torch.cli.train.main) on a seeded synthetic WSJ0-mix
     folder for TRAIN_WARMUP + TRAIN_TIMED micro-steps, validates once and
     writes a checkpoint. Every loss must be finite and every micro-step
     must launch TRAIN_PER_STEP kernels (forward, backward); every kernel
     shape of a micro-step is held against its plain version and timed;
     the checkpoint's EMA weights must separate a mixture; the flagship's
     loss.backward() must reach every 3x3 conv weight; and a small float32
     model's loss and parameter gradients on the kernels must match the
     plain versions on the card and the CPU.

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
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_TIMED = 6, 2, 8  # the recipe's batch; micro-steps
# launches per training micro-step, (forward, backward): the conv's backward
# is cuDNN's; each FIR up's backward is a FIR down and each in-block FIR
# down's an up (the 6 input-pyramid downs take no gradient)
TRAIN_PER_STEP = {"conv3x3": (106, 0), "fir_down2x": (18, 18), "fir_up2x": (18, 12)}
# the small float32 model's parameter gradients, max |difference| over the
# global gradient norm: the kernels against the plain versions on the card,
# and the card against the CPU (the forward's GroupNorm rounding gap, phase 4)
GRAD_TOL = {"kernels vs plain on the card": 1e-4, "card vs cpu": 1e-3}
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


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper replaced by its plain PyTorch version."""
    from diffsep_tpu_torch.ops import conv3x3 as conv_mod
    from diffsep_tpu_torch.ops import fir_resample2x as fir_mod

    with contextlib.ExitStack() as stack:
        for mod, name in [(conv_mod, "conv3x3"), (fir_mod, "fir_down2x"), (fir_mod, "fir_up2x")]:
            stack.enter_context(mock.patch.object(mod, name, getattr(mod, name + "_plain")))
        yield


def loss_and_grads(model, draws, mix, tgt):
    """One micro-step's loss and parameter gradients (float32, on the CPU)
    for given draws, through the trainer's loss."""
    import torch

    from diffsep_tpu_torch.train.losses import Draws
    from diffsep_tpu_torch.train.trainer import make_loss_fn

    sm = model.score_model
    sm.zero_grad(set_to_none=True)
    dev = model.device
    loss = make_loss_fn(sm, model.sde, model.loss_cfg)(
        Draws(None, {k: torch.from_numpy(v).to(dev) for k, v in draws.items()}), mix.to(dev), tgt.to(dev))
    loss.backward()
    grads = {name: (p.grad if p.grad is not None else torch.zeros_like(p)).float().cpu()
             for name, p in sm.named_parameters()}
    return loss.item(), grads


def train_phase(dev, card, cycles_per_ms, rng, extra_overrides=()):
    """Phase 6: the recipe trains through its entry point; see the module
    docstring. ``extra_overrides`` go to the entry point after the phase's
    own. Returns the phase's report."""
    import tempfile

    import torch

    from diffsep_tpu_torch.cli import train as train_cli
    from diffsep_tpu_torch.data.audio_io import load_wav
    from diffsep_tpu_torch.data.synthetic import write_wsj0_mix
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.models import layers
    from diffsep_tpu_torch.ops import _build
    from diffsep_tpu_torch.train.checkpoints import load_payload

    out = {}
    steps = TRAIN_WARMUP + TRAIN_TIMED
    per_step = []
    make_train_step = DiffSepModel.make_train_step

    def counted_train_step(self, seed):
        """The train step, recording each micro-step's launches (all and
        backward), its kernel shapes and the peak memory after it."""
        train_step = make_train_step(self, seed)

        def run(state, mix, target, *args, **kwargs):
            before = [collections.Counter(c) for c in
                      (_build.launch_counts, _build.backward_counts, _build.launch_shapes)]
            metrics = train_step(state, mix, target, *args, **kwargs)
            after = (_build.launch_counts, _build.backward_counts, _build.launch_shapes)
            launches, backward, shapes = (collections.Counter(a) - b for a, b in zip(after, before))
            per_step.append(dict(launches=dict(launches), backward=dict(backward), shapes=shapes,
                                 batch=list(mix.shape), peak_gib=torch.cuda.max_memory_allocated() / 2**30))
            return metrics

        return run

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        data = write_wsj0_mix(Path(tmp) / "wsj0_mix", {"train": 2 * TRAIN_BATCH, "val": 5},
                              seconds=SERVE_SECONDS, fs=FS, seed=0)
        overrides = ["experiment=icassp-separation", f"path.datasets.wsj0_mix={data}",
                     f"path.exp_root={tmp}/exp", f"trainer.max_steps={steps}", "model.valid_max_sep_batches=1", *extra_overrides]
        log(f"[train] python -m diffsep_tpu_torch.cli.train {' '.join(overrides)}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        t0 = time.perf_counter()
        with mock.patch.object(DiffSepModel, "make_train_step", counted_train_step):
            state = train_cli.main(overrides)
        torch.cuda.synchronize()
        out["run_s"] = time.perf_counter() - t0
        out["launches"] = dict(_build.launch_counts)
        out["backward_launches"] = dict(_build.backward_counts)
        run_dir = next(Path(tmp, "exp").glob("*/*/train_log.jsonl")).parent
        records = [json.loads(line) for line in (run_dir / "train_log.jsonl").read_text().splitlines()]
        index = json.loads((run_dir / "checkpoints" / "index.json").read_text())
        val = index[str(steps)]
        assert state.step == steps and len(per_step) == steps, (state.step, len(per_step))

        # speed: host clock from the start of the first timed micro-step to the
        # synchronize that ends the last one
        rows = [r for r in records if "step" in r]
        start = next(r["start_s"] for r in rows if r["step"] == TRAIN_WARMUP + 1)
        end = [r["synced_s"] for r in records if "synced_s" in r][-1]
        ms = (end - start) * 1e3 / TRAIN_TIMED
        out.update(
            batch=per_step[0]["batch"], ms_per_micro_step=ms, micro_steps_per_s=1e3 / ms,
            samples_per_s=TRAIN_BATCH * 1e3 / ms, peak_gib=max(s["peak_gib"] for s in per_step),
            losses=[r["train/score_loss"] for r in rows], grad_norms=[r["grad/norm"] for r in rows],
            validation=val, per_step=[dict(launches=s["launches"], backward=s["backward"]) for s in per_step],
        )
        log(f"[train] {steps} micro-steps of batch {out['batch']} in {out['run_s']:.1f} s with validation "
            f"and checkpoint; timed {TRAIN_TIMED} after {TRAIN_WARMUP}: {ms:.2f} ms per micro-step, "
            f"{out['micro_steps_per_s']:.3f} micro-steps/s, {out['samples_per_s']:.3f} samples/s, "
            f"peak {out['peak_gib']:.2f} GiB ({card})")
        for r in rows:
            log(f"[train] micro-step {r['step']}: loss {r['train/score_loss']:.6g} "
                f"grad norm {r['grad/norm']:.6g} lr {r['lr']:.3g}")
        log(f"[train] validation: {val}")
        log(f"[train] launches per micro-step {per_step[-1]['launches']}, of them backward "
            f"{per_step[-1]['backward']}; whole run {out['launches']}")
        assert all(np.isfinite(out["losses"])) and all(np.isfinite(out["grad_norms"])), out["losses"]
        assert np.isfinite(val["val/score_loss"]) and np.isfinite(val["val/si_sdr"]), val
        want = {k: sum(v) for k, v in TRAIN_PER_STEP.items()}
        want_bwd = {k: v[1] for k, v in TRAIN_PER_STEP.items() if v[1]}
        for s in per_step:
            assert s["launches"] == want and s["backward"] == want_bwd, (s["launches"], s["backward"])

        # the checkpoint reloads, and its EMA weights separate one mixture
        payload = load_payload(run_dir / "checkpoints" / "latest.pt")
        ema = payload["train_state"]["ema"]
        assert payload["step"] == steps and ema["num_updates"] == steps // 2, (payload["step"], ema["num_updates"])
        model = DiffSepModel(payload["config"], device=dev, seed=1)
        model.score_model.load_state_dict(ema["params"], strict=True)
        del payload, ema
        mix_path = sorted((data / "2speakers/wav8k/max/cv/mix").iterdir())[0]
        mix1 = torch.from_numpy(load_wav(mix_path)[0][None])
        est, nfe = model.separate(mix1, generator=torch.Generator(device=dev).manual_seed(0))
        assert est.shape == (1, 2, mix1.shape[-1]) and torch.isfinite(est).all(), est.shape
        log(f"[train] checkpoint {run_dir.name}/checkpoints/latest.pt reloaded: its EMA weights separate "
            f"{mix_path.name} in {nfe} evaluations, output {tuple(est.shape)}, finite")

        # the flagship's loss.backward() reaches every 3x3 conv weight
        b_rng = np.random.default_rng(5)
        n = SERVE_SECONDS * FS
        draws = {"mask": np.array([0.05, 0.5, 0.5, 0.5, 0.5, 0.05], np.float32),
                 "z0": b_rng.standard_normal((TRAIN_BATCH, 2, n), dtype=np.float32),
                 "z": b_rng.standard_normal((TRAIN_BATCH, 2, n), dtype=np.float32),
                 "shuffle": b_rng.uniform(size=(TRAIN_BATCH, 2)).astype(np.float32),
                 "time": b_rng.uniform(size=TRAIN_BATCH).astype(np.float32)}
        tgt6 = torch.from_numpy(0.1 * b_rng.standard_normal((TRAIN_BATCH, 2, n), dtype=np.float32))
        mix6 = tgt6.sum(dim=1, keepdim=True)
        _, grads = loss_and_grads(model, draws, mix6, tgt6)
        conv_w = [name + ".weight" for name, m in model.score_model.named_modules()
                  if isinstance(m, layers.Conv) and m.weight.shape[-1] == 3]
        dead = [w for w in conv_w if not (torch.isfinite(grads[w]).all() and grads[w].abs().max() > 0)]
        assert len(conv_w) == PER_EVAL["conv3x3"] and not dead, (len(conv_w), dead)
        log(f"[train] flagship loss.backward(): all {len(conv_w)} 3x3 conv weights have a finite, "
            f"nonzero gradient")
        del model, grads

    # every kernel shape of a micro-step (forward and backward), bf16,
    # against its plain version, timed
    shapes = per_step[-1]["shapes"]
    checks = []
    for i, ((k, shape, cout), cnt) in enumerate(sorted(shapes.items(), key=str)):
        r = check_kernel(k, shape, cout, "bfloat16", dev, 100 + i, cycles_per_ms)
        r["launches_per_micro_step"] = cnt
        checks.append(r)
        log(f"[train-kernel] {k} {shape}->{cout} bf16 x{cnt}:{plan_text(r['plan'])} "
            f"err {r['max_abs_err']:.3g} (tol {r['tol']:.3g}) ms {r['ms']:.4f} plain {r['plain_ms']:.4f} "
            f"lib {r['library_ms']:.4f} bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")
    out["kernel_checks"] = checks
    bad = [r for r in checks if not r["ok"]]
    assert not bad, f"kernel mismatches at training shapes: {bad}"

    # a small float32 model: loss and gradients, kernels vs plain on the
    # card, and the card vs the CPU
    small = {"score_model": {"backbone_args": {
        "nf": 32, "ch_mult": (1, 1, 2, 2), "num_res_blocks": 1, "dtype": "float32"}}}
    m_gpu = DiffSepModel(small, device=dev, seed=1)
    m_cpu = DiffSepModel(small, device="cpu", seed=1)
    randomize_(m_cpu.score_model, seed=3)
    m_gpu.score_model.load_state_dict(m_cpu.score_model.state_dict())
    b, n = 2, FS
    tgt = torch.from_numpy(rng.standard_normal((b, 2, n)).astype(np.float32))
    mix = tgt.sum(dim=1, keepdim=True)
    # one sample on the init branch (t = T), one on the regular one
    draws = {"mask": np.array([0.05, 0.9], np.float32),
             "z0": rng.standard_normal((b, 2, n)).astype(np.float32),
             "z": rng.standard_normal((b, 2, n)).astype(np.float32),
             "shuffle": rng.uniform(size=(b, 2)).astype(np.float32),
             "time": rng.uniform(size=b).astype(np.float32)}
    res, counts = {}, {}
    for route in ("kernels", "plain"):
        with plain_kernels() if route == "plain" else contextlib.nullcontext():
            _build.reset_counts()
            res[route] = loss_and_grads(m_gpu, draws, mix, tgt)
            torch.cuda.synchronize()
            counts[route] = (dict(_build.launch_counts), dict(_build.backward_counts))
    res["cpu"] = loss_and_grads(m_cpu, draws, mix, tgt)

    def grad_err(a, b):
        ga, gb = res[a][1], res[b][1]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in gb.values())).item()
        return max((ga[k] - gb[k]).abs().max().item() for k in gb) / norm

    pairs = {"kernels vs plain on the card": ("kernels", "plain"), "card vs cpu": ("kernels", "cpu"),
             "plain on the card vs cpu": ("plain", "cpu")}
    small_check = {name: grad_err(a, b) for name, (a, b) in pairs.items()}
    loss_rel = {name: abs(res[a][0] - res[b][0]) / abs(res[b][0]) for name, (a, b) in pairs.items()}
    out["small_f32_grad_check"] = dict(grad_rel_err=small_check, loss_rel_err=loss_rel, tol=GRAD_TOL,
                                       launches=counts["kernels"], losses={k: v[0] for k, v in res.items()})
    for name, v in small_check.items():
        log(f"[train] nf=32 f32 parameter gradients, {name}: {v:.3g} of the gradient norm "
            f"(loss {loss_rel[name]:.3g} relative)")
    log(f"[train] nf=32 launches (all, backward): kernels {counts['kernels']}; plain {counts['plain']}")
    for name, tol in GRAD_TOL.items():
        assert small_check[name] <= tol and loss_rel[name] <= tol, (name, small_check[name], loss_rel[name])
    assert all(counts["kernels"][0].get(k, 0) > 0 for k in TRAIN_PER_STEP), counts
    assert all(counts["kernels"][1].get(k, 0) > 0 for k in ("fir_down2x", "fir_up2x")), counts
    assert not counts["plain"][0], counts
    return out


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
                stack.enter_context(plain_kernels())
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

    # 6. training phase
    report["train"] = train = train_phase(dev, card, cycles_per_ms, rng)

    # summary per kernel: the bf16 (serving) times summed over one score
    # evaluation's launches at batch 2, and the bf16 times summed over one
    # training micro-step's launches (forward and backward) at batch 6;
    # launches over both main paths, the serving run at N=30 and the
    # training run
    serve_counts = serve["reverse_diffusion+ald2 N=30"]["launches"]
    summary = []
    for k, meta in KERNELS.items():
        rows = [r for r in results if r["kernel"] == k]
        bf = [r for r in rows if r["dtype"] == "bfloat16"]
        tr = [r for r in train["kernel_checks"] if r["kernel"] == k]

        def per_eval_sum(key):
            return sum(r[key] * r["launches_per_eval"] for r in bf)

        def per_step_sum(key):
            return sum(r[key] * r["launches_per_micro_step"] for r in tr)

        summary.append(dict(
            name=k, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=serve_counts[k] + train["launches"][k],
            max_abs_err=max(r["max_abs_err"] for r in rows + tr),
            ms=per_eval_sum("ms"), plain_ms=per_eval_sum("plain_ms"),
            bound_ms=per_eval_sum("bound_ms"),
            bound_by="operations" if per_eval_sum("ops_ms") >= per_eval_sum("bytes_ms") else "bytes",
            library_ms=per_eval_sum("library_ms"),
            launches_by_path={"serve N=30": serve_counts[k], "train": train["launches"][k],
                              "train backward": train["backward_launches"].get(k, 0)},
            launches_per_micro_step={"forward": TRAIN_PER_STEP[k][0], "backward": TRAIN_PER_STEP[k][1]},
            train_ms_per_micro_step=per_step_sum("ms"), train_plain_ms=per_step_sum("plain_ms"),
            train_bound_ms=per_step_sum("bound_ms"), train_library_ms=per_step_sum("library_ms"),
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
