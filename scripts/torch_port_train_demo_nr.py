#!/usr/bin/env python3
"""The enhancement learning check of the PyTorch/CUDA port: the JAX package's
scripts/train_demo_nr.py, trained and sampled by diffsep_tpu_torch.

The noise-reduction recipe (``model=nr``: PriorMixSDE, whose diffusion
follows the noisy input's power envelope, init_hack 4, enhancement cast as
two "sources", target [clean, noisy - clean]) on a small NCSN++ (nf 32,
ch_mult (1, 1, 2), one res block, attention at 64, bf16 compute, f32
parameters) learns to enhance synthetic noisy speech-like clips (harmonic
stacks under an on/off envelope in pink-ish noise, made from a seed) for
``steps`` Adam steps at batch 16 x 1 s, 16 kHz. Its EMA weights then
enhance 8 held-out clips with the PC sampler (reverse_diffusion + ald2,
N=30); the clean estimate (channel 0) is scored by SI-SDR and PESQ-wb
against the unprocessed noisy floor.

    python scripts/torch_port_train_demo_nr.py [steps] [--seed S]
        [--dtype bfloat16|float32] [--remat] [--out PATH] [--save-ckpt PATH]
        [--device cpu] [--tiny] [--plain-kernels]
    python scripts/torch_port_train_demo_nr.py 2000 --seeds 0,1,2 [--out-dir DIR]
        [--save-ckpt PATH]

Seeds, as scripts/torch_port_train_demo.py takes them: the data stream is
numpy's ``default_rng(seed)``, draw for draw the JAX script's (one init
batch first); the weights are drawn from ``seed``, the training step's draws
from ``1000 * seed + 1``; the held-out set (``default_rng(123)``) and the
sampler's generator (seeded 7) are the same for every seed. The record has
every key of scripts/train_demo_nr_result.json, plus the seed, the card,
seconds and hand-kernel launches per step and the peak memory.

``--seeds`` runs each seed in a process of its own, all at once, writes
DIR/torch_port_train_demo_nr_seed{S}.json, then
DIR/torch_port_train_demo_nr_spread.json: each si_sdr_* and pesq_* metric
as {mean, min, max, spread, values} over the seeds, with the bar of ``BAR``
checked on the records. With ``--seeds``, ``--save-ckpt PATH`` writes seed
S's teacher to PATH with ``_seed{S}`` before its suffix.

``--save-ckpt`` writes the EMA weights as the port's weights file and a
provenance sidecar beside it: the teacher of
scripts/torch_port_distill_demo_nr.py. ``--tiny`` rehearses on the CPU: nf
8, batch 2 x 0.5 s, 2 held-out clips of 0.5 s. Without ``--device`` the
demo runs on the card, and raises where there is none.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
for _p in (str(HERE.parent), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch_port_train_demo as demo  # noqa: E402  (the port's training loop, seed runner, teacher file)

FS, SAMPLES, BATCH, NF = 16000, 16000, 16, 32
HELDOUT_SEED, HELDOUT_BATCH, EVAL_SEED, PC_N = 123, 8, 7, 30
# PESQ-wb scores an utterance of at least a quarter second: 0.5 s clips keep
# the tiny rehearsal's held-out scoring (and its floor) on the real path
TINY = {"nf": 8, "batch": 2, "samples": 8000, "heldout": 2}
# the JAX package's one seed at 2000 steps (scripts/train_demo_nr_result.json):
# SI-SDR 20.29 dB and PESQ-wb 4.439 from the noisy 8.98 dB and 1.882. One seed
# at 2000 steps: the margins are wider than the separation demo's ~1 dB
BAR = {"si_sdr_enhanced_db": {"each": 18.8, "mean": 19.3},
       "pesq_wb_enhanced": {"each": 4.20},
       "si_sdr_noisy_floor_db": {"value": 8.98, "abs": 0.01},
       "pesq_wb_noisy_floor": {"value": 1.882, "abs": 0.001}}


def make_batch(rng, b, n, fs=FS):
    """"Speech": a harmonic stack with a slow on/off envelope and a random
    pitch; "noise": pink-ish broadband noise. A copy of
    scripts/train_demo_nr.py:make_batch: the same draws give the same
    arrays, bit for bit. Returns (noisy (b, 1, n), target [clean, noisy -
    clean] (b, 2, n)), float32."""
    t = np.arange(n) / fs
    clean = np.zeros((b, n))
    for i in range(b):
        f0 = rng.uniform(90, 250)
        env = np.clip(np.sin(2 * np.pi * rng.uniform(1.5, 4.0) * t + rng.uniform(0, 6.3)), 0, None)
        sig = sum(
            rng.uniform(0.4, 1.0) / (k + 1) * np.sin(2 * np.pi * f0 * (k + 1) * t + rng.uniform(0, 6.3))
            for k in range(6)
        )
        clean[i] = env * sig
    clean /= np.maximum(np.std(clean, axis=-1, keepdims=True), 1e-8)
    clean *= 0.1
    # pink-ish noise: cumulative-sum-filtered white noise, power matched
    w = rng.standard_normal((b, n))
    pink = np.cumsum(w, axis=-1)
    pink -= np.mean(pink, axis=-1, keepdims=True)
    pink /= np.maximum(np.std(pink, axis=-1, keepdims=True), 1e-8)
    noise = (0.5 * pink + 0.5 * w / np.std(w, axis=-1, keepdims=True)) * 0.05
    noisy = clean + noise
    tgt = np.stack([clean, noisy - clean], axis=1).astype(np.float32)
    return noisy[:, None, :].astype(np.float32), tgt


def nr_overrides(dtype="bfloat16", remat=False, nf=NF):
    """The JAX script's overrides (``model=nr`` first), with the dtype and
    remat of the flags. The recipe keeps its own ``train_source_order``
    (None), unlike the separation demo's ``power``."""
    return [
        "model=nr",
        f"model.score_model.backbone_args.nf={nf}",
        "model.score_model.backbone_args.ch_mult=[1,1,2]",
        "model.score_model.backbone_args.num_res_blocks=1",
        "model.score_model.backbone_args.attn_resolutions=[64]",
        f"model.score_model.backbone_args.dtype={dtype}",
        f"model.score_model.backbone_args.remat={str(remat).lower()}",
        "model.optimizer.lr=0.001",
        "trainer.accumulate_grad_batches=1",
    ]


def build_model(dtype="bfloat16", remat=False, device=None, seed=0, nf=NF):
    from diffsep_tpu_torch.config.compose import compose
    from diffsep_tpu_torch.model import DiffSepModel

    return DiffSepModel(compose(nr_overrides(dtype, remat, nf)), device=device, seed=seed)


def train(model, seed, steps, rng, b=BATCH, n=SAMPLES, log=print, draws=None):
    """The separation demo's loop (``torch_port_train_demo.train``) on this
    recipe's batches: ``steps`` steps after the JAX script's init batch."""
    return demo.train(model, seed, steps, rng, b, n, log=log, draws=draws, make=make_batch)


def metrics():
    """The JAX script's metrics: SI-SDR and PESQ-wb of channel 0."""
    from diffsep_tpu_torch.models.losses import PESQ, SISDRLoss

    return (SISDRLoss(zero_mean=True, clamp_db=30, reduction="mean", sign_flip=True),
            PESQ(mode="wb", fs=FS, max_items=8))


def floors(mix_te, tgt_te):
    """SI-SDR (dB) and PESQ-wb of the unprocessed noisy input against the
    clean target."""
    import torch

    si_sdr, pesq_wb = metrics()
    mix, clean = torch.from_numpy(mix_te), torch.from_numpy(tgt_te[:, :1])
    return float(si_sdr(mix, clean)), float(pesq_wb(mix, clean))


def enhance_scores(model, mix_te, tgt_te, noise=None, **kw):
    """Enhance the held-out noisy clips with the weights ``model`` holds
    (the sampler's settings in ``kw``; its generator seeded EVAL_SEED, the
    JAX script's PRNGKey(7) for every sampler; ``noise`` hands it given
    draws) and score the clean estimate, channel 0. The noisy input goes to
    ``separate`` whole: PriorMixSDE's envelope is computed from it, and
    ``separate`` normalizes it. Returns (SI-SDR dB, PESQ-wb, score
    evaluations)."""
    import torch

    si_sdr, pesq_wb = metrics()
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(EVAL_SEED)
    est, nfe = model.separate(torch.from_numpy(mix_te).to(dev), generator=gen, noise=noise, **kw)
    est_clean = est[:, :1].float().cpu()
    clean = torch.from_numpy(tgt_te[:, :1])
    return float(si_sdr(est_clean, clean)), float(pesq_wb(est_clean, clean)), nfe


def evaluate(model, state, mix_te, tgt_te, noise=None):
    """``enhance_scores`` of the EMA weights of ``state`` with the PC sampler
    at N=PC_N; the model holds the trained weights again after it."""
    from diffsep_tpu_torch.train.ema import swapped

    with swapped(state.ema, state.params):
        return enhance_scores(model, mix_te, tgt_te, noise=noise, N=PC_N)


def score(model, state, mix_te, tgt_te):
    """The record's metrics: the EMA weights' SI-SDR and PESQ-wb at PC N=30
    (``evaluate``) against the noisy floors. Returns (metrics, score
    evaluations)."""
    si_est, pesq_est, nfe = evaluate(model, state, mix_te, tgt_te)
    si_floor, pesq_floor = floors(mix_te, tgt_te)
    return {
        "si_sdr_noisy_floor_db": round(si_floor, 2),
        "si_sdr_enhanced_db": round(si_est, 2),
        "improvement_db": round(si_est - si_floor, 2),
        "pesq_wb_noisy_floor": round(pesq_floor, 3),
        "pesq_wb_enhanced": round(pesq_est, 3),
    }, nfe


RECIPE = demo.Recipe(build_model, make_batch, score,
                     {"nf": NF, "batch": BATCH, "samples": SAMPLES, "heldout": HELDOUT_BATCH}, TINY)


def run_seed(steps, seed, dtype="bfloat16", remat=False, device=None, tiny=False, log=print, plain=False):
    """One seed's training and evaluation (``torch_port_train_demo.run_seed``
    on this recipe); ``plain`` runs every hand kernel's plain PyTorch
    version instead (a diagnostic). Returns (record, model, state)."""
    if not plain:
        return demo.run_seed(steps, seed, dtype, remat, device, tiny, log, recipe=RECIPE)
    from diffsep_tpu_torch.ops.plain import plain_kernels

    with plain_kernels():
        record, model, state = demo.run_seed(steps, seed, dtype, remat, device, tiny, log, recipe=RECIPE)
    record["plain_kernels"] = True
    return record, model, state


def spread_record(records, steps):
    """The seeds' spread of the SI-SDR and PESQ-wb metrics, ``BAR`` checked
    on the records."""
    return demo.spread_record(records, steps, BAR, keep=lambda k: k.startswith(("si_sdr_", "pesq_wb_")))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=2000)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--seed", type=int, default=0,
                    help="training seed: the data stream, the init and the step's draws; the held-out set "
                    "and the sampler's generator stay fixed")
    ap.add_argument("--seeds", default=None, help="comma-separated seeds, each run in a process of its own")
    ap.add_argument("--out", default="torch_port_train_demo_nr_result.json", help="the record of one seed")
    ap.add_argument("--out-dir", default=str(HERE), help="where --seeds writes its records")
    ap.add_argument("--save-ckpt", default=None,
                    help="write the trained EMA weights here (the port's weights file) and a provenance "
                    "sidecar beside it; with --seeds, each seed's with _seed{S} before the suffix")
    ap.add_argument("--device", default=None, help="cpu, cuda or cuda:N (default: the card)")
    ap.add_argument("--tiny", action="store_true", help="a CPU rehearsal at nf 8, batch 2 x 0.5 s")
    ap.add_argument("--plain-kernels", action="store_true",
                    help="a diagnostic: every hand kernel replaced by its plain PyTorch version")
    args = ap.parse_args(argv)
    if args.seeds:
        extra = (lambda s: ["--save-ckpt", str(demo.seed_path(args.save_ckpt, s))]) if args.save_ckpt else None
        demo.run_seeds(args, [int(s) for s in args.seeds.split(",")], script=__file__,
                       prefix="torch_port_train_demo_nr", spread=spread_record, extra=extra)
        return 0

    def log(msg):
        print(f"[seed {args.seed}] {msg}", flush=True)

    record, model, state = run_seed(args.steps, args.seed, args.dtype, args.remat, args.device, args.tiny, log,
                                    plain=args.plain_kernels)
    print(json.dumps(record), flush=True)
    Path(args.out).write_text(json.dumps(record, indent=2))
    if args.save_ckpt:
        demo.save_teacher(args.save_ckpt, model, state, record)
        log(f"teacher saved to {args.save_ckpt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
