#!/usr/bin/env python3
"""The data-parallel route of the port over every visible GPU (NCCL).

    python3 scripts/torch_port_ddp.py [--report PATH] [--rows 6] [--steps 6]

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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--report", type=Path, default=None, help="write every result to this JSON file")
    ap.add_argument("--rows", type=int, default=6, help="rows per rank")
    ap.add_argument("--steps", type=int, default=6, help="micro-steps (even: accumulation 2)")
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
