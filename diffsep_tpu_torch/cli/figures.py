"""The paper's figures.

Counterpart of ``diffsep_tpu/cli/figures.py`` (the reference's figure_*
scripts), one subcommand each:

  sde_marginal_evolution     the mean-matrix coefficients, the mixture
                             error and the sources' correlation over t for
                             several d_lambda values, on WSJ0-mix's
                             validation split, or on synthetic mixtures
                             where the folder is absent;
  reverse_diffusion_example  the spectrograms of the reverse process of a
                             trained run dir (its EMA weights) on one
                             validation mixture, as ``eval_common.save_fig``
                             draws them;
  samples                    sample vignettes at SI-SDR percentiles of a
                             result folder (``cli.evaluate``'s JSON and wavs);
  exp_inference              a metric against an inference setting, parsed
                             from result-dir names as
                             ``eval_common.sampler_run_config`` writes them.

    python -m diffsep_tpu_torch.cli.figures SUBCOMMAND [args] [--device cpu]

Each runs on CUDA unless ``--device cpu``. matplotlib is imported only to
draw, so a figure needs it installed; each subcommand returns what it
plotted.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _parser(**kw) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(**kw)
    parser.add_argument("--out", type=Path, default=Path("figures"))
    parser.add_argument("--device", default=None, help="default: cuda")
    return parser


# --------------------------------------------------------------------------
def sde_marginal_evolution(argv=None) -> dict:
    from ..data.wsj0_mix import WSJ0_mix
    from ..sde import MixSDE
    from ..train.losses import normalize_batch

    parser = _parser()
    parser.add_argument("--data", type=Path, default=Path("data/wsj0_mix"))
    parser.add_argument("--limit", type=int, default=5)
    parser.add_argument("--d-lambdas", type=float, nargs="+", default=[2, 3, 4])
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    def iter_samples():
        try:
            ds = WSJ0_mix(args.data, 2, 8000, "max", "val")
            for i in range(min(args.limit, len(ds))):
                yield ds[i]
        except (FileNotFoundError, OSError):
            rng = np.random.default_rng(0)
            for _ in range(args.limit):
                tgt = rng.standard_normal((2, 8000)).astype(np.float32) * 0.1
                yield tgt.sum(0, keepdims=True), tgt

    t = torch.linspace(0.01, 1.0, 200, device=device)
    curves = {}
    for d_lambda in args.d_lambdas:
        sde = MixSDE(ndim=2, d_lambda=d_lambda, sigma_min=0.05, sigma_max=0.5, N=30)
        mmat = sde._mean_mix_mat(t)  # (T, 2, 2)
        error_T = torch.zeros(t.shape, dtype=torch.float64, device=device)
        n = 0
        for mix, tgt in iter_samples():
            (mix, tgt), _, _ = normalize_batch(torch.from_numpy(mix)[None].to(device),
                                               torch.from_numpy(tgt)[None].to(device))
            x_T = (0.5 * mix).expand(1, 2, mix.shape[-1])
            mu = torch.einsum("tij,bjn->tbin", mmat, tgt)  # the marginal's mean on the t grid
            error_T += ((x_T[None] - mu) ** 2).sum(dim=(1, 2, 3)).double()
            n += tgt.shape[1] * tgt.shape[2]
        L = sde._std(t)
        cov = (L @ L).cpu().numpy()
        mm = mmat.cpu().numpy()
        curves[d_lambda] = dict(error=(error_T / n).cpu().numpy(), coef_diag=mm[:, 0, 0], coef_off=mm[:, 0, 1],
                                corr=cov[:, 0, 1] / cov[:, 0, 0])

    plt = _mpl()
    tt = t.cpu().numpy()
    fig, (ax1, ax2, ax3) = plt.subplots(1, 3, figsize=(9, 3))
    for d_lambda, c in curves.items():
        label = f"$\\gamma={d_lambda}$"
        ax1.semilogy(tt, c["error"], "-", label=label)
        ax2.plot(tt, c["coef_diag"], "-", label=label)
        ax2.plot(tt, c["coef_off"], "--")
        ax3.plot(tt, c["corr"], label=label)
    ax1.set_title(r"$E\|\mu_t - \bar{s}\|^2$")
    ax2.set_title(r"Coefficients of $e^{-t\gamma P}$")
    ax3.set_title("Pearson corr. coeff.")
    for ax in (ax1, ax2, ax3):
        ax.set_xlabel("Time $t$")
    ax3.legend()
    args.out.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(args.out / "paper_sde_marginal_evolution.pdf")
    plt.close(fig)
    return {"t": tt, "curves": curves}


# --------------------------------------------------------------------------
def reverse_diffusion_example(argv=None):
    """Returns the sampled sources, the evaluations and the (N, 2, 1, n_src,
    T) stack of each step's (x, x_mean)."""
    from ..data.wsj0_mix import WSJ0_mix
    from ..train.losses import normalize_batch
    from . import eval_common
    from .loading import load_model

    parser = _parser()
    parser.add_argument("ckpt", type=Path)
    parser.add_argument("--data", type=Path, default=Path("data/wsj0_mix"))
    parser.add_argument("--index", type=int, default=0)
    parser.add_argument("-N", type=int, default=30)
    parser.add_argument("--seed", type=int, default=0, help="seed of the sampler's draws")
    args = parser.parse_args(argv)

    model = load_model(args.ckpt, device=resolve_device(args.device))
    ds = WSJ0_mix(args.data, 2, int(model.config["fs"]), "max", "val")
    mix, target = ds[args.index]
    (mix, target), _, _ = normalize_batch(torch.from_numpy(mix)[None], torch.from_numpy(target)[None])
    generator = torch.Generator(device=model.device).manual_seed(args.seed)
    sampler = model.get_pc_sampler("reverse_diffusion", "ald2", mix, generator=generator, N=args.N,
                                   intermediate=True, snr=0.5, corrector_steps=1)
    x, nfe, ims = sampler()
    args.out.mkdir(parents=True, exist_ok=True)
    eval_common.save_fig(x.cpu().numpy(), ims.cpu().numpy(), target.numpy(), args.out, args.index)
    return x, nfe, ims


# --------------------------------------------------------------------------
def samples(argv=None) -> list:
    """Sample vignettes by SI-SDR percentile; returns the picked records."""
    from ..data.audio_io import load_wav

    parser = _parser()
    parser.add_argument("results", type=Path, help="result folder with <split>.json and wav/")
    parser.add_argument("--split", default="test")
    parser.add_argument("--percentiles", type=float, nargs="+", default=[10, 50, 90])
    args = parser.parse_args(argv)
    resolve_device(args.device)

    results = json.loads((args.results / f"{args.split}.json").read_text())
    if isinstance(results, dict):  # evaluate_mp's records are keyed
        results = sorted(results.values(), key=lambda r: r["batch_idx"])
    sisdr = np.array([np.mean(r["si_sdr"]) for r in results])
    order = np.argsort(sisdr)
    picks = [results[order[int(np.clip(p / 100 * (len(order) - 1), 0, len(order) - 1))]]
             for p in args.percentiles]

    plt = _mpl()
    fig, axes = plt.subplots(len(picks), 3, figsize=(9, 2.5 * len(picks)), squeeze=False)
    wav_dir = args.results / "wav" / args.split
    for row, (p, res) in enumerate(zip(args.percentiles, picks)):
        idx = res["batch_idx"]
        for col, name in enumerate(["mix", "enh0", "tgt0"]):
            f = wav_dir / f"{idx:03d}_{name}.wav"
            if not f.exists():
                continue
            sig, fs = load_wav(f)
            ax = axes[row, col]
            ax.specgram(sig[0], Fs=fs)
            ax.set_xticks([])
            ax.set_yticks([])
            if col == 0:
                ax.set_ylabel(f"p{p:.0f}: {np.mean(res['si_sdr']):.1f} dB")
            if row == 0:
                ax.set_title(name)
    args.out.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(args.out / f"samples_{args.split}.pdf")
    plt.close(fig)
    return picks


# --------------------------------------------------------------------------
def parse_name(name: str) -> dict:
    """The inference settings in a result-dir name's
    `..._N-30_snr-0.5_corrstep-1_denoise-True_schedule-None[_pred-.._corr-..][_avgk-..]`."""
    ret = {}
    for f in name.split("_"):
        if "-" not in f:
            continue
        key, _, val = f.partition("-")
        if key in ("N", "corrstep", "avgk"):
            ret[key] = int(val)
        elif key == "snr":
            ret[key] = float(val)
        elif key == "denoise":
            ret[key] = val == "True"
        elif key == "schedule":
            ret[key] = None if val == "None" else val
        elif key in ("pred", "corr"):
            ret[key] = val
    return ret


def exp_inference(argv=None) -> dict:
    """A metric against the setting ``key`` over the result dirs beside
    ``path_base`` named after it; returns the plotted series."""
    parser = _parser(description="Create figure from experiment data")
    parser.add_argument("path_base", type=Path, help="base path of experiment data")
    parser.add_argument("key", type=str, help="key to use as x axis")
    args = parser.parse_args(argv)
    resolve_device(args.device)

    pesq, sisdr = [], []
    for split in ["val", "test"]:
        for subfold in args.path_base.parent.rglob(f"{args.path_base.name}*"):
            inf = parse_name(subfold.name)
            summary = subfold / f"{split}_summary.json"
            if args.key not in inf or not summary.exists():
                continue
            data = json.loads(summary.read_text())
            if "pesq" in data:
                pesq.append((inf[args.key], data["pesq"]))
            if "si_sdr" in data:
                sisdr.append((inf[args.key], data["si_sdr"]))

    plt = _mpl()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(8, 3))
    for ax, series, label in [(ax1, sorted(pesq), "pesq"), (ax2, sorted(sisdr), "si-sdr (dB)")]:
        if series:
            ax.plot([a[0] for a in series], [a[1] for a in series], "o-")
        ax.set_ylabel(label)
        ax.set_xlabel(args.key)
    args.out.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(args.out / f"exp_inference_{args.key}.pdf")
    plt.close(fig)
    return {"pesq": sorted(pesq), "si_sdr": sorted(sisdr)}


COMMANDS = {
    "sde_marginal_evolution": sde_marginal_evolution,
    "reverse_diffusion_example": reverse_diffusion_example,
    "samples": samples,
    "exp_inference": exp_inference,
}


def main(argv=None):
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit(f"usage: figures <{'|'.join(COMMANDS)}> [args...]")
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
