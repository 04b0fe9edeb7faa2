"""Helpers shared by the evaluation and inference CLIs: metrics, summaries,
saved samples and figures, and the sampler flags.

Counterpart of ``diffsep_tpu/cli/eval_common.py``, with the same result
JSON per utterance: {batch_idx, si_sdr, si_sir, si_sar, pesq, stoi, nfe,
runtime, len_s}. Everything here works on host numpy arrays.
"""
from __future__ import annotations

import logging
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..data.audio_io import save_wav
from ..models.metrics import si_bss_eval_sources, stoi

log = logging.getLogger(__name__)


def compute_metrics(ref, est, fs, pesq_mode="nb", stoi_extended=True, n_src=2):
    """(si_sdr, si_sir, si_sar, pesq, stoi, perm) of one utterance (batch 1),
    ref and est numpy (1, n_src, T): the permutation of best mean SI-SDR,
    then PESQ (NaN where it cannot score) and STOI of its first n_src
    sources."""
    ref = np.asarray(ref)
    est = np.asarray(est)
    si_sdr, si_sir, si_sar, perm = si_bss_eval_sources(
        ref, est, zero_mean=False, compute_permutation=True, clamp_db=100
    )
    est = est[:, perm[0], :]

    from ..models.pesq_native import get_pesq

    _pesq = get_pesq()
    p_esq, s_toi = [], []
    for src in range(n_src):
        try:
            p_esq.append(float(_pesq(fs, ref[0, src], est[0, src], pesq_mode)))
        except Exception:
            p_esq.append(float("nan"))
        s_toi.append(float(stoi(ref[0, src], est[0, src], fs, extended=stoi_extended)))

    return (
        si_sdr[..., :n_src],
        si_sir[..., :n_src],
        si_sar[..., :n_src],
        p_esq,
        s_toi,
        perm,
    )


def summarize(results):
    """Every record key averaged over the utterances (a record's list its
    finite mean first), with "number"; an all-NaN metric summarizes to
    NaN without numpy warnings."""
    metrics = set()
    summary = defaultdict(lambda: 0.0)
    for res in results:
        for met, val in res.items():
            metrics.add(met)
            vals = np.atleast_1d(np.asarray(val, dtype=np.float64))
            finite = vals[np.isfinite(vals)]
            summary[met] += finite.mean() if finite.size else np.nan
        summary["number"] += 1
    for met in metrics:
        summary[met] = float(summary[met] / summary["number"])
    summary["number"] = int(summary["number"])
    return dict(summary)


def summarize_mp(results, ignore_inf=True):
    """The multi-process CLI's summary, as the JAX package computes it:
    results is a dict keyed by sample index; per record, each metric's mean
    is added unless ignore_inf is False and the mean is inf (so at the
    default an inf poisons the summary, and NaN always passes); each metric
    divides by its own add count, batch_idx included."""
    metrics = set()
    summary = defaultdict(lambda: 0.0)
    denominator = defaultdict(lambda: 0)
    for res in results.values():
        for met, val in res.items():
            metrics.add(met)
            val_mean = np.mean(np.asarray(val, dtype=np.float64))
            if ignore_inf or not np.isinf(val_mean):
                summary[met] += val_mean
                denominator[met] += 1
        summary["number"] += 1
    for met in metrics:
        d = denominator[met]
        with np.errstate(invalid="ignore", divide="ignore"):
            summary[met] = float(np.float64(summary[met]) / d)
    summary["number"] = int(summary["number"])
    return dict(summary)


def experiment_tag(ckpt, tag):
    """The result dir's `{exp_name}_{ckpt_name}` tag (or `tag` itself where
    given): exp_name is a checkpoint file's grandparent directory (the run
    dir holding hparams.yaml), or a run dir's own name, ckpt_name the
    path's stem."""
    ckpt = Path(ckpt)
    if tag is not None:
        return tag
    # resolve() first: a bare relative filename has no parents[1]
    exp_name = (
        ckpt.resolve().parents[1].name if ckpt.is_file() else ckpt.name
    )
    out = f"{exp_name}_{ckpt.stem}"
    if len(out) > 80:  # keep names filesystem-safe
        import hashlib

        out = out[:64] + "-" + hashlib.sha1(out.encode()).hexdigest()[:8]
    return out


def save_samples(mix, x_result, target, wav_out_dir, fs, batch_idx):
    """The mixture, estimates and targets of one utterance as wavs, scaled
    together to a peak of 0.95."""
    wav_out_dir = Path(wav_out_dir)
    wav_out_dir.mkdir(parents=True, exist_ok=True)
    mix = np.asarray(mix)[0]
    est = np.asarray(x_result)[0]
    tgt = np.asarray(target)[0]
    all_wav = np.concatenate((mix, est, tgt), axis=0)
    all_wav = all_wav * (0.95 / np.abs(all_wav).max())
    names = (
        ["mix"]
        + [f"enh{i}" for i in range(est.shape[0])]
        + [f"tgt{i}" for i in range(tgt.shape[0])]
    )
    for row, name in zip(all_wav, names):
        save_wav(wav_out_dir / f"{batch_idx:03d}_{name}.wav", row[None], fs)


def save_fig(
    x_result, intmet, target, fig_out_dir, batch_idx, n_fig=6, vmin=-75, vmax=0
):
    """Spectrograms of the reverse process's steps beside the targets, as a
    PDF. `intmet` is the (N, 2, B, src, T) stack of
    pc_sample(intermediate=True). matplotlib is imported here: evaluation
    without figures (--save-n 0) does not need it."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig_out_dir = Path(fig_out_dir)
    fig_out_dir.mkdir(parents=True, exist_ok=True)
    x_result = np.asarray(x_result)
    target = np.asarray(target)
    n_src = target.shape[1]

    n_steps = len(intmet)
    steps = np.round(np.linspace(0, 1, n_fig) * (n_steps - 1)).astype(np.int64)
    fig, axes = plt.subplots(n_src, n_fig + 1, figsize=(20, 4))
    im = None
    for idx, step in enumerate(steps):
        arr = np.asarray(intmet[step][0])
        for i in range(n_src):
            *_, im = axes[i, idx].specgram(arr[0, i], vmin=vmin, vmax=vmax)
            axes[i, idx].set_xticks([])
            axes[i, idx].set_yticks([])
            if i == 0:
                axes[i, idx].set_title(
                    f"t={(n_steps - 1 - step) / (n_steps - 1):.2f}"
                )
    for i in range(n_src):
        tgt = target[0, i] + np.random.randn(*target[0, i].shape) * 1e-10
        *_, im = axes[i, -1].specgram(tgt, vmin=vmin, vmax=vmax)
        axes[i, -1].set_xticks([])
        axes[i, -1].set_yticks([])
        if i == 0:
            axes[i, -1].set_title("clean")
    fig.tight_layout()
    fig.subplots_adjust(right=0.8)
    cbar_ax = fig.add_axes([0.85, 0.15, 0.05, 0.7])
    fig.colorbar(im, cax=cbar_ax)
    fig.savefig(fig_out_dir / f"evo_{batch_idx:03d}.pdf")
    plt.close(fig)


def str2bool(v):
    """argparse-friendly boolean (``type=bool`` takes 'False' as True):
    true/false/1/0/yes/no in any case."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("1", "true", "t", "yes", "y"):
        return True
    if v.lower() in ("0", "false", "f", "no", "n"):
        return False
    raise ValueError(f"expected a boolean, got {v!r}")


def sampler_flag_map(args) -> dict:
    """The sampler flags a CLI's parsed ``args`` has, by flag name (None =
    not set by the user)."""
    return {flag: getattr(args, attr) for attr, flag in (
        ("N", "-N"), ("snr", "--snr"), ("corrector_steps", "--corrector-steps"),
        ("predictor", "--predictor"), ("corrector", "--corrector"),
        ("schedule", "--schedule"), ("denoise", "--denoise"),
    ) if hasattr(args, attr)}


def apply_pinned_sampler(args, cfg) -> None:
    """Fill the sampler flags the user left unset (``predictor``,
    ``corrector``, ``N``, ``schedule``) from the sampler a model's config
    pins: a distilled student's run dir (``cli/distill.py``) names its
    predictor, corrector, N and schedule, so the CLIs sample it at its own N
    without flags. A config that names no predictor pins nothing, and the
    CLIs keep their own defaults."""
    sk = dict(cfg.get("sampler") or {})
    if "predictor_name" not in sk:
        return
    for attr, key in (("predictor", "predictor_name"), ("corrector", "corrector_name"), ("N", "N"),
                      ("schedule", "schedule")):
        if getattr(args, attr, None) is None and sk.get(key) is not None:
            setattr(args, attr, sk[key])


def reject_baked_flags(set_map: dict, why: str) -> None:
    """SystemExit naming every flag of ``set_map`` that is set, where the
    sampler is fixed and cannot take them."""
    set_flags = [k for k, v in set_map.items() if v is not None]
    if set_flags:
        raise SystemExit(f"{', '.join(set_flags)}: {why}")


def sampler_run_config(cfg, args, ckpt):
    """The sampler settings of an evaluation (the checkpoint's config,
    overridden by the CLI flags) and the result dir's inference tag, as the
    JAX CLI names it: `N-.._snr-.._corrstep-.._denoise-.._schedule-..`, with
    the predictor and corrector where they are not the production pair and
    the number of checkpoints averaged. ``cfg`` is the model's config node.

    Returns (sampler_kwargs, tag_inf).
    """
    sk = dict(cfg.get("sampler", {}) or {})
    N = sk.get("N", 30) if args.N is None else args.N
    snr = sk.get("snr", 0.5) if args.snr is None else args.snr
    corrector_steps = (
        sk.get("corrector_steps", 1)
        if args.corrector_steps is None
        else args.corrector_steps
    )
    sampler_kwargs = dict(
        N=N, snr=snr, corrector_steps=corrector_steps,
        denoise=args.denoise, schedule=args.schedule,
    )
    tag_inf = (
        f"N-{N}_snr-{snr}_corrstep-{corrector_steps}"
        f"_denoise-{args.denoise}_schedule-{args.schedule}"
    )
    predictor = getattr(args, "predictor", None)
    corrector = getattr(args, "corrector", None)
    if (predictor, corrector) not in ((None, None), ("reverse_diffusion", "ald2")):
        # another sampler pair gets its own result dir
        tag_inf += f"_pred-{predictor}_corr-{corrector}"
    if getattr(args, "avg_last_k", None) and args.avg_last_k > 1:
        # the number actually averaged, which may be fewer than asked
        from .loading import resolve_avg_steps

        k_eff = len(resolve_avg_steps(ckpt, args.avg_last_k))
        tag_inf += f"_avgk-{k_eff}"
    return sampler_kwargs, tag_inf
