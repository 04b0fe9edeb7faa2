#!/usr/bin/env python3
"""The data-parallel route of the port over every visible GPU (NCCL).

    python3 scripts/torch_port_ddp.py [--report PATH] [--rows 6] [--steps 6] [--slice12]

Needs at least two cards. One rank per visible card, each a process spawned
here, trains the ICASSP recipe at full width (nf=128, bf16) through
``cli.train.train`` and ``train.loop.fit`` on a seeded synthetic WSJ0-mix
folder: ``--rows`` rows per rank (the published recipe's 6 by default, so
the global batch is cards x 6), accumulation 2, ``--steps`` micro-steps,
one validation, one checkpoint, ``test=true``. The ranks must be
bit-identical after every optimizer step, rank 0 the only writer, and every
micro-step of every rank must launch the one-process kernel counts; ms per
micro-step (rank 0's log, after 2 micro-steps), global samples/s and peak
memory per rank are printed with the card's name and power limit. Then the
nf=32 float32 train and distillation steps through DDP over the same ranks
against one process on the whole batch (``chip_smoke.DDP_TOL`` of the
norms); ``cli.train`` with the published ``trainer=allgpus`` (devices -1:
one spawned worker per card) for 2 micro-steps; and ``cli.evaluate_mp`` on
the DDP run's checkpoint at N=30, over every card and over one, per
utterance and with ``--batch-size 4``, the launches exactly PER_EVAL x 60 x
the sampler runs. The rank processes and the phases reuse
``chip_smoke.py``'s (``ddp_worker``, ``small_ddp_updates``).

``--slice12`` measures the two other parallel modes instead, over NCCL:
``trainer.strategy=fsdp`` against ddp on the same rows (``--rows`` per
rank, ``--steps`` micro-steps in two epochs, a validation and a checkpoint
after each, through ``chip_smoke.fsdp_worker``): ms per micro-step over
the second epoch, samples/s, each
rank's parameter, optimizer and EMA bytes and peak, losses and parameters
against DDP's; then tensor-parallel separation of 5 s mixtures with ddim +
none at ``chip_smoke.TP_N`` (``chip_smoke.tp_worker``) at tp = 2 and 4
and dp x tp = 2 x 2, each against the replicated separation on one card
(tp = 1) of the same draws: seconds per utterance and peak per rank; and
each hand kernel's time at the shapes one rank runs at tp = 4, summed per
evaluation beside its plain version, library call and bound.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def slice12(world, card, tmp, rows, steps):
    """``--slice12``: FSDP against DDP over every card, tensor-parallel
    separation at tp = 2, 4 and 2 x 2, the kernels at the tp = 4 shapes."""
    import collections

    import numpy as np
    import torch

    from diffsep_tpu_torch.data.synthetic import write_wsj0_mix

    report = {}
    data = write_wsj0_mix(Path(tmp) / "wsj0_fsdp", {"train": world * rows * (steps // 2), "val": 5},
                          seconds=cs.SERVE_SECONDS, fs=cs.FS, seed=22)
    base = ["experiment=icassp-separation", f"path.datasets.wsj0_mix={data}", f"trainer.max_steps={steps}",
            "trainer.check_val_every_n_epoch=1", f"datamodule.train.dl_opts.batch_size={rows}",
            "model.valid_max_sep_batches=1", f"model.sampler.N={cs.FSDP_VAL_N}"]
    out_dir = Path(tmp) / "fsdp_reports"
    out_dir.mkdir()
    init_method = f"tcp://127.0.0.1:{cs.free_port()}"
    t0 = time.perf_counter()
    cs.run_ranks(cs.fsdp_worker, lambda r: (r, world, init_method, "nccl", r, base, f"{tmp}/exp_fsdp", str(out_dir)),
                 world, 1200)
    report["fsdp_ranks_s"] = time.perf_counter() - t0
    params = {}
    for strategy in ("ddp", "fsdp"):
        reps = [json.loads((out_dir / f"{strategy}_rank{r}.json").read_text()) for r in range(world)]
        run = next(Path(tmp, "exp_fsdp", strategy).glob("*/*/train_log.jsonl")).parent
        # the second epoch's micro-steps: the first epoch ends in a
        # validation and a checkpoint, which a window over both would hold
        speed, log_rows = cs.train_speed(run, steps // 2, steps - steps // 2, world * rows)
        params[strategy] = torch.load(out_dir / f"{strategy}_params.pt")
        want = {k: sum(v) for k, v in cs.TRAIN_PER_STEP.items()}
        assert all(p["launches"] == want for r in reps for p in r["per_step"]), strategy
        report[strategy] = dict(**speed, losses=[r["train/score_loss"] for r in log_rows],
                                start_s=[r["start_s"] for r in log_rows],
                                peak_gib_per_rank=[r["peak_gib"] for r in reps],
                                mib_per_rank={k: [r["bytes"][k] / 2**20 for r in reps] for k in reps[0]["bytes"]},
                                validations=reps[0]["validations"])
        cs.log(f"[slice12] {strategy}: {world} ranks x {rows} rows over nccl, {steps} micro-steps: "
               f"{speed['ms_per_micro_step']:.2f} ms per micro-step, {speed['samples_per_s']:.3f} samples/s; per "
               f"rank MiB {report[strategy]['mib_per_rank']}; peak per rank "
               f"{[round(r['peak_gib'], 3) for r in reps]} GiB; losses {report[strategy]['losses']} ({card[0]})")
    keys = sorted(params["ddp"])
    report["fsdp_vs_ddp"] = dict(
        loss_rel_err=max(abs(f - d) / abs(d) for f, d in zip(report["fsdp"]["losses"], report["ddp"]["losses"])),
        param_rel_err=cs.rel_err([params["fsdp"][k] for k in keys], [params["ddp"][k] for k in keys]))
    cs.log(f"[slice12] fsdp vs ddp: {report['fsdp_vs_ddp']}")

    report["tp"] = {}
    tp4_shapes = None
    for label, n, dp in (("tp=2", 2, 1), ("tp=4", 4, 1), ("dp x tp = 2 x 2", 4, 2)):
        if n > world:
            continue
        tp_dir = Path(tmp) / f"tp_{n}_{dp}"
        tp_dir.mkdir()
        init_method = f"tcp://127.0.0.1:{cs.free_port()}"
        cs.run_ranks(cs.tp_worker, lambda r: (r, n, init_method, "nccl", r, 41, str(tp_dir), dp), n, 900)
        tps = [torch.load(tp_dir / f"tp_rank{r}.pt", weights_only=False) for r in range(n)]
        ref = tps[0]["replicated"]
        err = max((t["est"] - ref).abs().max().item() for t in tps) / ref.abs().max().item()
        report["tp"][label] = dict(
            s_per_utterance=[t["tp_s_1"] / dp for t in tps], replicated_s_per_utterance=tps[0]["replicated_s"] / dp,
            peak_gib_per_rank=[t["peak_gib"] for t in tps],
            weight_mib_per_rank=[t["weight_bytes"] / 2**20 for t in tps],
            rel_err=err, launches_per_rank=tps[0]["launches"], nfe=tps[0]["nfe"])
        cs.log(f"[slice12] {label}: {report['tp'][label]['s_per_utterance']} s per {cs.SERVE_SECONDS} s utterance "
               f"per rank, replicated on one card (tp = 1) {report['tp'][label]['replicated_s_per_utterance']:.3f}; "
               f"against it {err:.3g} of scale; weights per rank {report['tp'][label]['weight_mib_per_rank']} MiB, "
               f"peak {report['tp'][label]['peak_gib_per_rank']} GiB; launches per rank {tps[0]['launches']} "
               f"({card[0]})")
        assert err <= cs.TP_TOL and all(t["launches"] == cs.launches_of(t["nfe"]) for t in tps), label
        if label == "tp=4":
            tp4_shapes = collections.Counter({(k, tuple(s), c): cnt for k, s, c, cnt in tps[0]["shapes"]})
            tp4_nfe = tps[0]["nfe"]
    if tp4_shapes is not None:
        dev = torch.device("cuda", 0)
        cyc = cs.sleep_cycles_per_ms()
        rows_ = []
        for i, (key, cnt) in enumerate(sorted(tp4_shapes.items(), key=str)):
            r = cs.check_kernel(*key, "bfloat16", dev, 4000 + i, cyc)
            r["launches_per_eval"] = cnt / tp4_nfe
            rows_.append(r)
            cs.log(f"[slice12-kernel] tp=4: {key[0]} {key[1]}->{key[2]} bf16 x{r['launches_per_eval']:g}:"
                   f"{cs.plan_text(r['plan'])} err {r['max_abs_err']:.3g} ms {r['ms']:.4f} plain {r['plain_ms']:.4f} "
                   f"lib {r['library_ms']:.4f} bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")
        assert all(r["ok"] for r in rows_)
        report["tp4_kernels"] = {k: {m: sum(r[m] * r["launches_per_eval"] for r in rows_ if r["kernel"] == k)
                                     for m in ("ms", "plain_ms", "library_ms", "bound_ms")}
                                 for k in cs.PER_EVAL}
        cs.log(f"[slice12] each hand kernel per evaluation on one rank at tp=4 (ms): {report['tp4_kernels']} "
               f"({card[0]})")
    return report


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--report", type=Path, default=None, help="write every result to this JSON file")
    ap.add_argument("--rows", type=int, default=6, help="rows per rank")
    ap.add_argument("--steps", type=int, default=6, help="micro-steps (even: accumulation 2)")
    ap.add_argument("--slice12", action="store_true", help="FSDP against DDP and tensor-parallel separation")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("torch_port_ddp: needs at least two CUDA devices", file=sys.stderr)
        return 2
    from diffsep_tpu_torch.cli import evaluate_mp
    from diffsep_tpu_torch.cli import train as train_cli
    from diffsep_tpu_torch.data.synthetic import write_wsj0_mix
    from diffsep_tpu_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    world = torch.cuda.device_count()
    cs.log(f"{world} cards: {card}")
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    _build.build_all()
    report = {"cards": card, "world": world, "rows": args.rows}
    per_rank_steps = args.steps
    if args.slice12:
        with tempfile.TemporaryDirectory(prefix="torch_port_slice12_") as tmp:
            report.update(slice12(world, card, tmp, args.rows, args.steps))
        if args.report is not None:
            args.report.parent.mkdir(parents=True, exist_ok=True)
            args.report.write_text(json.dumps(report, indent=1))
        print(json.dumps({k: report[k] for k in ("fsdp_vs_ddp", "tp", "tp4_kernels") if k in report}))
        return 0
    with tempfile.TemporaryDirectory(prefix="torch_port_ddp_") as tmp:
        data = write_wsj0_mix(Path(tmp) / "wsj0_mix", {"train": 2 * world * args.rows, "val": 5, "test": 4 * world},
                              seconds=cs.SERVE_SECONDS, fs=cs.FS, seed=20)
        overrides = ["experiment=icassp-separation", f"path.datasets.wsj0_mix={data}", f"path.exp_root={tmp}/exp",
                     f"trainer.max_steps={per_rank_steps}", f"trainer.check_val_every_n_epoch={per_rank_steps // 2}",
                     f"datamodule.train.dl_opts.batch_size={args.rows}", "model.valid_max_sep_batches=1",
                     "test=true"]
        out_dir = Path(tmp) / "reports"
        out_dir.mkdir()
        init_method = f"tcp://127.0.0.1:{cs.free_port()}"
        t0 = time.perf_counter()
        cs.run_ranks(cs.ddp_worker, lambda r: (r, world, init_method, "nccl", r, overrides, str(out_dir)), world,
                     1200)
        ranks_s = time.perf_counter() - t0
        reports = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]
        run_dir = next(Path(tmp, "exp").glob("*/*/train_log.jsonl")).parent
        speed, rows = cs.train_speed(run_dir, cs.TRAIN_WARMUP, per_rank_steps - cs.TRAIN_WARMUP, world * args.rows)
        want = {k: sum(v) for k, v in cs.TRAIN_PER_STEP.items()}
        assert all(r["step"] == per_rank_steps for r in reports), [r["step"] for r in reports]
        assert all(s["launches"] == want for r in reports for s in r["per_step"]), [r["per_step"] for r in reports]
        assert all(r["digests"] == reports[0]["digests"] for r in reports)
        assert [r["saves"] for r in reports] == [[per_rank_steps]] + [[]] * (world - 1)
        merged = json.loads((run_dir / "test_results" / "test.json").read_text())
        assert [m["batch_idx"] for m in merged] == list(range(4 * world))
        log_rows = [json.loads(line) for line in (run_dir / "train_log.jsonl").read_text().splitlines()]
        report["fit"] = dict(ranks_s=ranks_s, **speed, peak_gib_per_rank=[r["peak_gib"] for r in reports],
                             losses=[r["train/score_loss"] for r in rows], launches=[r["launches"] for r in reports],
                             timeline=[[r.get("step"), r.get("start_s", r.get("synced_s"))] for r in log_rows])
        cs.log(f"[ddp] {world} ranks x {args.rows} rows over nccl, {per_rank_steps} micro-steps, validation, "
               f"checkpoint and test=true on {4 * world} files in {ranks_s:.1f} s with start-up; timed "
               f"{per_rank_steps - cs.TRAIN_WARMUP} after {cs.TRAIN_WARMUP}: {speed['ms_per_micro_step']:.2f} ms per "
               f"micro-step, {speed['samples_per_s']:.3f} global samples/s, peak per rank "
               f"{', '.join('%.2f' % r['peak_gib'] for r in reports)} GiB; ranks bit-identical after each of "
               f"{len(reports[0]['digests'])} optimizer steps, launches per rank per micro-step "
               f"{reports[0]['per_step'][-1]['launches']} ({card[0]})")
        cs.log(f"[ddp] rank 0's host clock, s from the fit's start, per micro-step start ([step, s]) and "
               f"per epoch's synchronize ([None, s]): {report['fit']['timeline']}")

        one = cs.small_ddp_updates(torch.device("cuda", 0))
        small = {}
        got = [torch.load(out_dir / f"small_rank{r}.pt", weights_only=False) for r in range(world)]
        for kind in ("train", "distill"):
            g = got[0][kind]
            assert all(all(torch.equal(a, b) for a, b in zip(x[kind]["mu"] + x[kind]["nu"], g["mu"] + g["nu"]))
                       for x in got), kind
            small[kind] = dict(
                loss_rel_err=max(abs(a - b) / abs(b) for a, b in zip(g["losses"], one[kind]["losses"])),
                mu_rel_err=cs.rel_err(g["mu"], one[kind]["mu"]), nu_rel_err=cs.rel_err(g["nu"], one[kind]["nu"]),
                tol=cs.DDP_TOL)
            cs.log(f"[ddp] nf=32 f32 {kind} step, {world} ranks (nccl) vs one process on the whole batch: loss "
                   f"{small[kind]['loss_rel_err']:.3g} relative, Adam mu {small[kind]['mu_rel_err']:.3g}, nu "
                   f"{small[kind]['nu_rel_err']:.3g} of their norms (tol {cs.DDP_TOL:g}); ranks bit-identical")
            assert all(v <= cs.DDP_TOL for k, v in small[kind].items() if k != "tol"), small[kind]
        report["small_f32_ddp_check"] = small

        t0 = time.perf_counter()
        ov = ["experiment=icassp-separation", f"path.datasets.wsj0_mix={data}", f"path.exp_root={tmp}/exp_allgpus",
              "trainer.max_steps=2", "model.valid_max_sep_batches=1"]
        train_cli.main(ov)
        run_all = next(Path(tmp, "exp_allgpus").glob("*/*/train_log.jsonl")).parent
        ckpts = sorted(json.loads((run_all / "checkpoints" / "index.json").read_text()))
        report["allgpus"] = dict(seconds=time.perf_counter() - t0, checkpoints=ckpts)
        cs.log(f"[ddp] cli.train {' '.join(ov)} (trainer=allgpus: {world} spawned workers over nccl): "
               f"{report['allgpus']['seconds']:.1f} s with start-up, checkpoints {ckpts}")
        assert ckpts == ["2"], ckpts

        n_files = 4 * world
        report["evaluate_mp"] = {}
        all_cards = [str(i) for i in range(world)]
        for label, d, mode, runs in ((f"{world} cards, per utterance", all_cards, [], n_files),
                                     (f"{world} cards, --batch-size 4", all_cards, ["--batch-size", "4"], world),
                                     ("1 card, --batch-size 4", ["0"], ["--batch-size", "4"], world)):
            torch.cuda.synchronize()
            _build.reset_counts()
            t0 = time.perf_counter()
            out = evaluate_mp.main([str(run_dir), "-d", *d, "-N", str(cs.PROD_N), "-o", str(Path(tmp) / "eval"),
                                    *mode])
            wall = time.perf_counter() - t0
            launches = dict(_build.launch_counts)
            records = json.loads((out / "test.json").read_text())
            runtime = [r["runtime"] for r in records.values()]
            report["evaluate_mp"][label] = dict(wall_s=wall, s_per_utt_wall=wall / n_files,
                                                s_per_utt_runtime=float(np.mean(runtime)), launches=launches)
            cs.log(f"[ddp] cli.evaluate_mp -d {' '.join(d)} -N {cs.PROD_N} {' '.join(mode)} ({label}): {n_files} "
                   f"files of {cs.SERVE_SECONDS} s in {wall:.1f} s with loading = {wall / n_files:.3f} s per "
                   f"utterance; runtime per utterance {np.mean(runtime):.3f} s; launches {launches} ({card[0]})")
            assert list(records) == [str(i) for i in range(n_files)]
            assert launches == {k: v * cs.PROD_NFE * runs for k, v in cs.PER_EVAL.items()}, launches
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))
    print(json.dumps({k: v for k, v in report.items() if k != "fit"} | {"fit": {
        k: v for k, v in report["fit"].items() if k != "launches"}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
