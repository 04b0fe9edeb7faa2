"""Evaluation spread over several devices, per utterance or batched.

    python -m diffsep_tpu_torch.cli.evaluate_mp RUN_DIR [--splits test val] \\
        [-d 0 1] [-b 4 --bucket-s 1] [-N 30] [...]
    python -m diffsep_tpu_torch.cli.evaluate_mp __no_proc__ --device cpu

Counterpart of ``diffsep_tpu/cli/evaluate_mp.py``: the split's index range
is cut into one contiguous range per device (``make_tasks``), each range is
scored in a thread of its own on its own copy of the model, and the records
are merged by index into ``{split}.json`` (a dict keyed by index) and
``{split}_summary.json`` (``summarize_mp``) under
``OUTPUT/<run>_<ckpt>_N-.._snr-.._corrstep-.._denoise-.._schedule-..``.

``-d`` names the devices: CUDA indices (default: every visible GPU; an
index given twice runs two workers on one card) or ``cpu``. Each utterance
is normalized by its mixture's statistics and sampled at its own length;
``-b/--batch-size`` instead batches utterances of the same length bucket
(``--bucket-s``), each row normalized on its true length and then padded,
the batch padded with zero rows to its full size, the metrics computed on a
host thread pool while the card samples the next batch (``runtime`` is the
batch's time over its real rows). Utterance i draws from
``step_generator(seed, i)``; a batch from its first utterance's.
``__no_proc__`` scores the unprocessed mixture of ``data/wsj0_mix``; a
distilled stage's run dir samples at its pinned sampler unless flags say
otherwise.
"""
from __future__ import annotations

import argparse
import json
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List

import numpy as np
import torch

from .. import resolve_device
from ..data import WSJ0_mix
from ..model import _device_scope
from ..parallel.shard_eval import model_copies
from ..train.losses import normalize_batch, normalize_rows_host
from ..train.trainer import step_generator
from .eval_common import (apply_pinned_sampler, compute_metrics, experiment_tag, sampler_run_config, str2bool,
                          summarize_mp)
from .loading import load_model

log = logging.getLogger(__name__)


def make_tasks(n_items: int, n_workers: int):
    """range(n_items) cut into one contiguous (start, stop) per worker (the
    empty ones left out)."""
    per = -(-n_items // n_workers)
    tasks = []
    for w in range(n_workers):
        start, stop = w * per, min((w + 1) * per, n_items)
        if start < stop:
            tasks.append((start, stop))
    return tasks


def _record(idx, si_sdr, si_sir, si_sar, p_esq, s_toi, n_src, nfe, runtime, len_s):
    return {
        "batch_idx": idx,
        # nested [[...]]: the record schema of the JAX CLI (the slice hits
        # the batch axis)
        "si_sdr": si_sdr.tolist()[:n_src],
        "si_sir": si_sir.tolist()[:n_src],
        "si_sar": si_sar.tolist()[:n_src],
        "pesq": p_esq,
        "stoi": s_toi,
        "nfe": int(nfe),
        "runtime": runtime,
        "len_s": float(len_s),
    }


def evaluate_range(model, dataset, start, stop, fs, n_src, sampler_kwargs, pesq_mode, stoi_extended, seed,
                   predictor="reverse_diffusion", corrector="ald2"):
    """dataset[start:stop] on ``model``'s device, one utterance at a time;
    returns the records."""
    results = []
    dev = model.device
    for idx in range(start, stop):
        mix, target = dataset[idx]
        mix = torch.from_numpy(np.asarray(mix, np.float32)[None]).to(dev)
        target = np.asarray(target)[None]
        (mix_n, _), mean, std = normalize_batch(mix)
        t_s = time.perf_counter()
        sampler = model.get_pc_sampler(predictor, corrector, mix_n, generator=step_generator(seed, idx, dev),
                                       **sampler_kwargs)
        x, nfe = sampler()
        x = x.cpu().numpy()  # waits for the card
        t_proc = time.perf_counter() - t_s
        # compared in the normalized domain, as the JAX CLI does
        target_n = (target - mean.cpu().numpy()) / std.cpu().numpy()
        si_sdr, si_sir, si_sar, p_esq, s_toi, _ = compute_metrics(
            target_n, x, fs, pesq_mode=pesq_mode, stoi_extended=stoi_extended, n_src=n_src)
        results.append(_record(idx, si_sdr, si_sir, si_sar, p_esq, s_toi, n_src, np.asarray(nfe).ravel()[0],
                               t_proc, target.shape[-1] / fs))
        log.info("%s[%d] si_sdr=%.2f runtime=%.2fs", dev, idx, float(np.mean(si_sdr)), t_proc)
    return results


def evaluate_range_batched(model, dataset, start, stop, fs, n_src, sampler_kwargs, pesq_mode, stoi_extended,
                           seed, batch_size, bucket_s, predictor="reverse_diffusion", corrector="ald2"):
    """Throughput mode: dataset[start:stop] in batches of ``batch_size``
    utterances of one length bucket, on ``model``'s device, the metrics on
    a host thread pool; returns the records."""
    dev = model.device
    bucket = max(int(bucket_s * fs), 1)
    groups = {}
    for idx in range(start, stop):
        mix, target = dataset[idx]
        groups.setdefault(-(-mix.shape[-1] // bucket), []).append((idx, mix, target))

    def metrics_row(idx, target, mean_j, std_j, est, length, nfe, t_proc):
        tgt_n = (target[None] - mean_j) / std_j
        si_sdr, si_sir, si_sar, p_esq, s_toi, _ = compute_metrics(
            tgt_n, est, fs, pesq_mode=pesq_mode, stoi_extended=stoi_extended, n_src=n_src)
        return _record(idx, si_sdr, si_sir, si_sar, p_esq, s_toi, n_src, nfe, t_proc, length / fs)

    futures, results = [], []
    with ThreadPoolExecutor(max_workers=4) as pool:
        for n_buckets, items in sorted(groups.items()):
            padded_len = n_buckets * bucket
            for off in range(0, len(items), batch_size):
                chunk = items[off:off + batch_size]
                # each row normalized on its true length, then padded
                rows, mean, std = normalize_rows_host([np.asarray(m, np.float32) for _, m, _ in chunk],
                                                      padded_len)
                real = len(chunk)
                rows += [np.zeros_like(rows[0])] * (batch_size - real)  # one shape per bucket
                mix_n = torch.from_numpy(np.stack(rows)).to(dev)
                t_s = time.perf_counter()
                sampler = model.get_pc_sampler(predictor, corrector, mix_n,
                                               generator=step_generator(seed, chunk[0][0], dev), **sampler_kwargs)
                x_b, nfe = sampler()
                x_b = x_b.cpu().numpy()  # waits for the card
                t_proc = (time.perf_counter() - t_s) / real
                nfe0 = int(np.asarray(nfe).ravel()[0])
                # backpressure: metrics slower than sampling would hold every
                # estimate in host memory
                while len(futures) > 64:
                    results.append(futures.pop(0).result())
                for j, (idx, mix, target) in enumerate(chunk):
                    n = mix.shape[-1]
                    futures.append(pool.submit(metrics_row, idx, np.asarray(target), mean[j], std[j],
                                               x_b[j:j + 1, :, :n].copy(), n, nfe0, t_proc))
                log.info("%s[batch@%d x%d] %.2fs/utt", dev, chunk[0][0], real, t_proc)
        results.extend(f.result() for f in futures)
    return results


def evaluate_range_no_proc(dataset, start, stop, fs, n_src, pesq_mode, stoi_extended):
    """``__no_proc__``: the mixture itself scored as every source's
    estimate; nfe 0, runtime 0."""
    results = []
    for idx in range(start, stop):
        mix, target = dataset[idx]
        mix, target = np.asarray(mix)[None], np.asarray(target)[None]
        si_sdr, si_sir, si_sar, p_esq, s_toi, _ = compute_metrics(
            target, np.broadcast_to(mix, target.shape), fs, pesq_mode=pesq_mode, stoi_extended=stoi_extended,
            n_src=n_src)
        results.append(_record(idx, si_sdr, si_sir, si_sar, p_esq, s_toi, n_src, 0, 0.0, target.shape[-1] / fs))
    return results


def parse_devices(names) -> List[torch.device]:
    """``-d``'s entries (CUDA indices or ``cpu``) as devices; by default
    every visible GPU, and none raises."""
    if not names:
        resolve_device("cuda")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = [torch.device("cuda", int(n)) if str(n).isdigit() else torch.device(n) for n in names]
    for dev in out:
        resolve_device(dev)
    return out


def build_parser():
    parser = argparse.ArgumentParser(description="Multi-device sharded evaluation")
    parser.add_argument("ckpt", type=Path)
    parser.add_argument("-o", "--output_dir", type=Path, default=Path("results"))
    parser.add_argument("--splits", nargs="+", default=["test"], choices=["test", "val", "libri-clean", "libri-noisy"])
    parser.add_argument("-d", "--device", nargs="+", default=None,
                        help="CUDA device indices (repeats run several workers on one card) or cpu "
                        "(default: every visible GPU)")
    parser.add_argument("-l", "--limit", type=int, default=None)
    parser.add_argument("-b", "--batch-size", type=int, default=None,
                        help="Batch same-length-bucket utterances per device for throughput "
                        "(default: per utterance)")
    parser.add_argument("--bucket-s", type=float, default=1.0, help="Length bucket in seconds for --batch-size")
    parser.add_argument("-N", type=int, default=None)
    parser.add_argument("--snr", type=float, default=None)
    parser.add_argument("--corrector-steps", type=int, default=None)
    parser.add_argument("--denoise", type=str2bool, default=True)
    parser.add_argument("-s", "--schedule", type=str, default=None)
    parser.add_argument("--pesq-mode", choices=["nb", "wb"], default="nb")
    parser.add_argument("--stoi-no-extended", action="store_true")
    parser.add_argument("--predictor", type=str, default=None,
                        help="Predictor name (default reverse_diffusion, or the sampler the run pins)")
    parser.add_argument("--corrector", type=str, default=None, help="Corrector name (default ald2, or the run's)")
    parser.add_argument("--tag", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--avg-last-k", type=int, default=None,
                        help="average the evaluation weights of the k most recent checkpoints "
                        "(checkpoint averaging; run-dir models only)")
    return parser


def _split_dataset(run_config, split: str) -> WSJ0_mix:
    node = run_config["datamodule"].get(split) or run_config["datamodule"].get("test")
    ds_cfg = dict(node["dataset"])
    ds_cfg.pop("_target_", None)
    if not Path(ds_cfg["path"]).exists():
        ds_cfg["path"] = "./data/wsj0_mix" if split in ("val", "test") else "./data/LibriMix"
    return WSJ0_mix(**ds_cfg)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    no_proc = str(args.ckpt) == "__no_proc__"
    devices = [torch.device("cpu")] * len(args.device or [None]) if no_proc else parse_devices(args.device)
    if no_proc:
        # the WSJ0_mix default of 16 kHz, in the dir "mix", as in the JAX CLI
        models, sampler_kwargs, fs, n_src = None, {}, 16000, 2
        output_dir = args.output_dir / (args.tag or "mix")
    else:
        model = load_model(args.ckpt, avg_last_k=args.avg_last_k, device=devices[0])
        apply_pinned_sampler(args, model.config)
        models = model_copies(model, devices)
        fs, n_src = int(model.config["fs"]), int(model.config["n_speakers"])
        sampler_kwargs, tag_inf = sampler_run_config(model.config, args, args.ckpt)
        output_dir = args.output_dir / f"{experiment_tag(args.ckpt, args.tag)}_{tag_inf}"
    output_dir.mkdir(parents=True, exist_ok=True)
    predictor, corrector = args.predictor or "reverse_diffusion", args.corrector or "ald2"
    stoi_extended = not args.stoi_no_extended

    for split in args.splits:
        if no_proc:
            # a libri-* split raises in WSJ0_mix rather than score WSJ0 data
            # under its label
            dataset = WSJ0_mix(path="data/wsj0_mix", n_spkr=2, cut="max", split=split)
        else:
            dataset = _split_dataset(models[0].run_config, split)
        n_items = len(dataset) if args.limit is None else min(len(dataset), args.limit)
        tasks = make_tasks(n_items, len(devices))
        log.info("Processing %s: %d samples over %d workers", split, n_items, len(tasks))

        chunks: list = [None] * len(tasks)
        errors: list = []

        def work(t_id, start, stop):
            try:
                if no_proc:
                    chunks[t_id] = evaluate_range_no_proc(dataset, start, stop, fs, n_src, args.pesq_mode,
                                                          stoi_extended)
                    return
                m = models[t_id]
                with _device_scope(m.device):
                    if args.batch_size:
                        chunks[t_id] = evaluate_range_batched(
                            m, dataset, start, stop, fs, n_src, sampler_kwargs, args.pesq_mode, stoi_extended,
                            args.seed, args.batch_size, args.bucket_s, predictor=predictor, corrector=corrector)
                    else:
                        chunks[t_id] = evaluate_range(
                            m, dataset, start, stop, fs, n_src, sampler_kwargs, args.pesq_mode, stoi_extended,
                            args.seed, predictor=predictor, corrector=corrector)
            except Exception as e:  # raised in the main thread below
                log.exception("worker %d failed", t_id)
                errors.append(e)

        threads = [threading.Thread(target=work, args=(t_id, start, stop), daemon=True)
                   for t_id, (start, stop) in enumerate(tasks)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]

        rows = sorted((r for chunk in chunks for r in chunk), key=lambda r: r["batch_idx"])
        # the JAX CLI's schema: a dict keyed by index, and the summary that
        # averages each metric over its own count
        results = {r["batch_idx"]: r for r in rows}
        with open(output_dir / f"{split}.json", "w") as f:
            json.dump(results, f, indent=2)
        summary = summarize_mp(results)
        with open(output_dir / f"{split}_summary.json", "w") as f:
            json.dump(summary, f, indent=2)
        log.info("%s summary: %s", split, summary)
    return output_dir


if __name__ == "__main__":
    main()
