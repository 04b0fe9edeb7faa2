"""Evaluation of a run on its validation or test split, in one process.

    python -m diffsep_tpu_torch.cli.evaluate RUN_DIR --test [--val] [-N 30]
    python -m diffsep_tpu_torch.cli.evaluate RUN_DIR --enhance --test
    python -m diffsep_tpu_torch.cli.evaluate __no_proc__ --val

Counterpart of ``diffsep_tpu/cli/evaluate.py``. Each utterance is
normalized by its mixture's statistics, zero-padded to whole seconds (one
program shape per 1 s bucket; PriorMixSDE's envelope sees the padding, as
in the JAX CLI), sampled, cut back to its length and scored: SI-SDR,
SI-SIR and SI-SAR under the best permutation, PESQ (NaN where it cannot
score) and STOI. It writes ``{split}.json`` (a record per utterance,
``si_sdr`` etc. as the nested ``[[...]]`` lists of the JAX CLI) and
``{split}_summary.json`` under ``OUTPUT/<run>_<ckpt>_N-.._snr-..``.
``--enhance`` scores the enhancement recipe's test set (its clean speech,
one source); ``__no_proc__`` scores the unprocessed mixture of
``data/wsj0_mix``. The first ``--save-n`` utterances (default: all) are
saved as wavs, with a figure of the reverse process where matplotlib is
installed (without it, none, and a warning). It runs on CUDA unless
``--device cpu``. ``cli/evaluate_mp.py`` spreads a split over several
devices and batches it.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..data import DataLoader, NoisyDataset, Subset, WSJ0_mix
from ..parallel import mesh
from ..train.ema import swapped
from ..train.losses import normalize_batch
from ..train.trainer import step_generator
from .eval_common import (apply_pinned_sampler, compute_metrics, experiment_tag, sampler_run_config, save_fig,
                          save_samples, str2bool, summarize)
from .loading import load_model

log = logging.getLogger(__name__)


def build_parser():
    parser = argparse.ArgumentParser(description="Run evaluation on validation or test dataset")
    parser.add_argument("ckpt", type=Path, help="Path to checkpoint to use")
    parser.add_argument("-o", "--output_dir", type=Path, default=Path("results"), help="The output folder")
    parser.add_argument("--enhance", default=False, action="store_true",
                        help="Compute evaluation metrics for speech enhancement")
    parser.add_argument("--tag", type=str, help="A tag name for the experiment (default: experiment+ckpt name)")
    parser.add_argument("-l", "--limit", type=int, help="Limit the number of samples to process")
    parser.add_argument("--save-n", type=int, help="Save a limited number of output samples (default: save all)")
    parser.add_argument("--val", action="store_true", help="Run on validation dataset")
    parser.add_argument("--test", action="store_true", help="Run on test dataset")
    parser.add_argument("-N", type=int, default=None, help="Number of steps")
    parser.add_argument("--snr", type=float, default=None, help="Corrector snr")
    parser.add_argument("--corrector-steps", type=int, default=None, help="Number of corrector steps")
    parser.add_argument("--denoise", type=str2bool, default=True, help="Use denoising in solver (true/false)")
    parser.add_argument("--pesq-mode", type=str, choices=["nb", "wb"], default="nb",
                        help="Mode for PESQ 'wb' or 'nb'")
    parser.add_argument("--stoi-no-extended", action="store_true", help="Disable extended STOI")
    parser.add_argument("-s", "--schedule", type=str, default=None,
                        help="Pick a different schedule for the inference")
    parser.add_argument("--predictor", type=str, default=None,
                        help="Predictor name (default reverse_diffusion, or the sampler the run pins; "
                        "ddim = fast exact-transition sampler)")
    parser.add_argument("--corrector", type=str, default=None,
                        help="Corrector name (default ald2, or the run's; none with ddim)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--avg-last-k", type=int, default=None,
                        help="average the evaluation weights of the k most recent checkpoints "
                        "(checkpoint averaging; run-dir models only)")
    parser.add_argument("--device", default=None, help="default: cuda")
    return parser


def evaluate_split(model, dataset, split, output_dir: Path, fs: int, n_src: int = 2, limit=None,
                   save_n=None, sampler_kwargs=None, pesq_mode="nb", stoi_extended=True, no_proc=False,
                   seed=0, bucket_s: float = 1.0, predictor="reverse_diffusion", corrector="ald2"):
    """Evaluate one split with the weights ``model`` holds; writes
    {split}.json and {split}_summary.json and returns (records, summary)."""
    output_dir.mkdir(parents=True, exist_ok=True)
    fig_dir = output_dir / "fig" / split
    wav_dir = output_dir / "wav" / split
    dl = DataLoader(dataset, batch_size=1, shuffle=False, num_shards=1, shard_index=0)
    results = []
    sampler_kwargs = dict(sampler_kwargs or {})
    figures = importlib.util.find_spec("matplotlib") is not None
    if not figures and save_n != 0:
        log.warning("matplotlib is not installed: saving wavs without figures")

    log.info("Processing %s: %d samples", split, len(dl))
    for batch_idx, (mix, target) in enumerate(dl):
        if limit is not None and batch_idx >= limit:
            break
        save_samples_fig = save_n is None or batch_idx < save_n
        mix, target = torch.from_numpy(mix), torch.from_numpy(target)
        length = target.shape[-1] / fs

        if no_proc:
            x_result = mix.expand(target.shape).numpy()
            nfe, intmet, t_proc = 0, None, 0.0
            save_samples_fig = False
        else:
            # the statistics of the unpadded mixture, then the zero pad to
            # the bucket; the sampler sees the padded mixture
            (mix, target), _, _ = normalize_batch(mix, target)
            n_samples = mix.shape[-1]
            bucket = max(int(bucket_s * fs), 1)
            mix_p = F.pad(mix, (0, -(-n_samples // bucket) * bucket - n_samples))
            sampler = model.get_pc_sampler(
                predictor, corrector, mix_p, generator=step_generator(seed, batch_idx, model.device),
                intermediate=save_samples_fig and figures, **sampler_kwargs)
            t_s = time.perf_counter()
            x_result, nfe, *others = sampler()
            x_result = x_result.cpu().numpy()  # waits for the card
            t_proc = time.perf_counter() - t_s
            x_result = x_result[..., :n_samples]
            intmet = others[0][..., :n_samples].cpu().numpy() if others else None

        target = target.numpy()
        si_sdr, si_sir, si_sar, p_esq, s_toi, perm = compute_metrics(
            target, x_result, fs, pesq_mode=pesq_mode, stoi_extended=stoi_extended, n_src=n_src)
        x_result = x_result[:, perm[0], :]
        results.append({
            "batch_idx": batch_idx,
            # nested [[...]]: the JAX CLI (and the reference it follows)
            # slices the (1, n_src) metric on its batch axis
            "si_sdr": si_sdr.tolist()[:n_src],
            "si_sir": si_sir.tolist()[:n_src],
            "si_sar": si_sar.tolist()[:n_src],
            "pesq": p_esq,
            "stoi": s_toi,
            "nfe": int(np.asarray(nfe).ravel()[0]) if not no_proc else 0,
            "runtime": t_proc,
            "len_s": float(length),
        })
        log.info("%s %s", split, " ".join(f"{met}={np.nanmean(val):.3f}" for met, val in results[-1].items()
                                          if met != "batch_idx"))
        if save_samples_fig:
            save_samples(mix.numpy(), x_result, target, wav_dir, fs, batch_idx)
            if intmet is not None:
                save_fig(x_result, intmet[:, :, :, perm[0], :], target, fig_dir, batch_idx)

    with open(output_dir / f"{split}.json", "w") as f:
        json.dump(results, f, indent=2)
    # every record key is averaged, batch_idx included, as in the JAX CLI
    summary = summarize(results)
    with open(output_dir / f"{split}_summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    return results, summary


def _dataset_config(run_config, split: str) -> dict:
    if run_config is None or "datamodule" not in run_config:
        raise ValueError("the checkpoint holds no datamodule config: evaluate a run dir of "
                         "diffsep_tpu_torch.cli.train or a checkpoint that has its config")
    ds_cfg = dict(run_config["datamodule"][split]["dataset"])
    ds_cfg.pop("_target_", None)
    return ds_cfg


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    if not (args.val or args.test):
        build_parser().error("No action requested, add --val or --test")

    no_proc = str(args.ckpt) == "__no_proc__"
    datasets = {}
    if no_proc:
        # the WSJ0_mix default of 16 kHz, as in the JAX CLI
        for split in ("val", "test"):
            if getattr(args, split):
                datasets[split] = WSJ0_mix(path="data/wsj0_mix", n_spkr=2, cut="max", split=split)
        model, sampler_kwargs, fs, n_src = None, {}, 16000, 2
        output_dir = args.output_dir / (args.tag or "mix")
    else:
        model = load_model(args.ckpt, avg_last_k=args.avg_last_k, device=resolve_device(args.device))
        apply_pinned_sampler(args, model.config)
        fs = int(model.config["fs"])
        if args.enhance:
            datasets["test"] = NoisyDataset(**_dataset_config(model.run_config, "test"))
            n_src = 1
        else:
            for split in ("val", "test"):
                if not getattr(args, split):
                    continue
                ds_cfg = _dataset_config(model.run_config, split)
                if not Path(ds_cfg["path"]).exists():
                    ds_cfg["path"] = "./data/wsj0_mix"
                datasets[split] = WSJ0_mix(**ds_cfg)
            n_src = 2
        sampler_kwargs, tag_inf = sampler_run_config(model.config, args, args.ckpt)
        output_dir = args.output_dir / f"{experiment_tag(args.ckpt, args.tag)}_{tag_inf}"

    for split, ds in datasets.items():
        evaluate_split(model, ds, split, output_dir, fs=fs, n_src=n_src, limit=args.limit, save_n=args.save_n,
                       sampler_kwargs=sampler_kwargs, pesq_mode=args.pesq_mode,
                       stoi_extended=not args.stoi_no_extended, no_proc=no_proc, seed=args.seed,
                       predictor=args.predictor or "reverse_diffusion", corrector=args.corrector or "ald2")


def evaluate_datamodule(model, state, dm, output_dir):
    """The test split of ``dm`` scored with the EMA weights of ``state``
    (cli/train.py's test=true): writes test.json and test_summary.json under
    ``output_dir`` and returns (records, summary).

    Under a process group of several ranks every rank scores a contiguous
    range of the split into ``part<rank>/`` (Lightning's DistributedSampler
    shards the reference's ``trainer.test``), then passes a barrier; rank 0
    merges the records in the split's order, numbers ``batch_idx`` anew and
    writes the single-process files. The other ranks return None."""
    if state is None:
        raise ValueError("evaluate_datamodule needs a train state with EMA weights")
    dataset = dm.datasets.get("test") or dm.test_dataloader().dataset
    output_dir = Path(output_dir)
    fs = int(model.config["fs"])
    n_proc, rank = mesh.world_size(), mesh.rank()
    with swapped(state.ema, state.params):
        if n_proc == 1:
            return evaluate_split(model, dataset, "test", output_dir, fs=fs,
                                  sampler_kwargs=dict(model.sampler_kwargs))
        per = -(-len(dataset) // n_proc)
        start, stop = min(rank * per, len(dataset)), min((rank + 1) * per, len(dataset))
        if stop > start:
            evaluate_split(model, Subset(dataset, range(start, stop)), "test", output_dir / f"part{rank}",
                           fs=fs, sampler_kwargs=dict(model.sampler_kwargs))
    mesh.barrier()
    if rank != 0:
        return None
    output_dir.mkdir(parents=True, exist_ok=True)
    results = []
    for i in range(n_proc):
        part = output_dir / f"part{i}" / "test.json"
        if part.exists():
            results.extend(json.loads(part.read_text()))
    for j, rec in enumerate(results):
        rec["batch_idx"] = j
    with open(output_dir / "test.json", "w") as f:
        json.dump(results, f, indent=2)
    summary = summarize(results)
    with open(output_dir / "test_summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    return results, summary


if __name__ == "__main__":
    main()
