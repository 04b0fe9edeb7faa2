#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (diffsep_tpu_torch) on one GPU (two
data-parallel ranks share it in phases 10 and 13; they take two where there
are).

    python3 chip_smoke.py [--report PATH]

Phases, each of which fails the run on any error. Phases 12, 15, 16 and
11 run in that order in a process of their own (``--side``), started once
phase 6 has written its folder and running beside phases 7-10, 13 and 14;
its log is printed after phase 14, and its failure fails the run at the next
phase boundary:
  1. build the hand-written kernels of diffsep_tpu_torch/csrc with nvcc;
  2. find the kernel shapes of one flagship score evaluation (NCSN++
     nf=128, bf16, batch 2 x 5 s at 8 kHz) by running it once;
  3. kernel phase: every kernel at every one of those shapes, in float32
     and bfloat16, against its plain PyTorch version on the card, timed
     beside the plain version and one library call (cuDNN with TF32 off),
     each as the device time of back-to-back calls, with the plan that
     ops/conv3x3.plan_conv3x3 or ops/fir_resample2x.plan_fir2x chose. A
     float32 conv's cuDNN call is timed with cudnn.benchmark off (its
     heuristic's algorithm) and on (its fastest), and the "tf32x3" plan's
     weight split is held bit for bit to its plain version and timed; the
     float32 convs are summed per evaluation;
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
     plain versions on the card and the CPU;
  7. serving entry points, on the run dir of phase 6 loaded with its EMA
     weights by cli.loading.load_model: HTTPSeparationServer over a
     SeparationEngine (batch 4, 1 s buckets, reverse_diffusion + ald2 at
     N=CHECK_N) takes 12 concurrent requests of seeded 3-6 s lengths and 2 bad
     ones (stereo, 16 kHz); every good one must come back 200 with 2
     finite channels at its own length, the bad ones 4xx, with no
     connection reset, /metrics must count them, and the launches must be
     the per-evaluation counts x 2 CHECK_N x the sampler runs. Then cli.serve's
     stdin loop in a process of its own (4 paths in one write, ddim N=6),
     separate_streaming on a 20 s mixture (5 s chunks, batch 8), and every
     new sampler (euler_maruyama, heun, dpmpp, langevin, ald, denoise off,
     ode_sample rk4) at full width on 2 x 5 s at N=4, each held to its
     launch count. Every kernel shape of these runs that phases 3 and 6
     did not check is held against its plain version in bf16. Last, each
     new sampler on the nf=32 float32 model of phase 4, card against CPU
     with the same draws, within 1e-3 of scale;
  8. enhancement: the noise-reduction recipe (PriorMixSDE, nf=128, bf16,
     batch 4 x 3 s at 16 kHz, accumulate 4, init hack 4) trains through
     cli.train.main on a seeded synthetic VCTK-DEMAND folder for
     ENH_WARMUP + ENH_TIMED micro-steps, validates once (val/si_sdr,
     val/pesq), writes a checkpoint and scores the test split (test=true;
     the run's sampler at N=CHECK_N); then cli.evaluate --enhance --test --save-n 0 and cli.separate (16 kHz
     files) on its run dir. Every loss must be finite, every micro-step
     must launch TRAIN_PER_STEP kernels and every other run PER_EVAL x its
     evaluations, the result JSON must have the JAX CLI's schema with
     finite SI-SDR and STOI; PESQ failures are counted. Every kernel shape
     of a micro-step is held against its plain version and timed, every
     other new one held untimed; the FIR down's backward at odd sizes and
     the resampling calls no kernel serves (run plain on the card) are
     held against their plain versions; and PriorMixSDE sampling
     (reverse_diffusion + ald2, ddim + none) on the nf=32 float32 model,
     card against CPU with the same draws, within 1e-3 of scale;
  9. distillation and the export artifact, on the run dir of phase 6:
     cli.distill (stages 4, 2 on the log grid, DISTILL_STEPS steps each of
     batch 6 x 5 s, 2 teacher substeps) times its steps after the first of
     each stage and must launch 3 forward evaluations and one backward per
     step (conv3x3 318 + 0, FIR down 54 + 18, FIR up 54 + 12); one
     on-policy step at N=2 adds one evaluation; cli.separate serves the N=2
     stage without sampler flags (PER_EVAL x 2 per file); cli.export_model
     exports it (batch 2 x 5 s), its calls are timed, launch PER_EVAL x 2
     inside the exported program and equal the live separate_masked on
     the same seed within 1e-5 of scale; cli.separate and cli.serve's stdin
     loop serve the artifact. Every new kernel shape of these runs is held
     against its plain version in bf16; and distill_loss's gradients on the
     nf=32 float32 model, kernels vs plain on the card and card vs CPU.

 10. data parallelism and multi-device evaluation: two ranks, each a
     process spawned here (over NCCL on two cards where there are two, else
     over gloo on the one card), train the recipe through cli.train.train
     and train.loop.fit (nf=128, bf16, DDP_BATCH rows each, accumulate 2,
     DDP_STEPS micro-steps, one validation, one checkpoint, test=true on
     DDP_TEST files, the sampler at N=CHECK_N): the ranks must be
     bit-identical after every optimizer step, rank 0 the only writer, the
     test records merged in order, every
     micro-step of every rank must launch TRAIN_PER_STEP kernels; ms per
     micro-step, global samples/s and peak memory per rank are recorded.
     The ranks then take the nf=32 float32 model's train step (two
     micro-steps) and distillation step through DDP on their halves of a
     batch and of its draws, held to one process on the whole batch within
     DDP_TOL of the norms. Then cli.train with the published trainer=allgpus
     (devices -1) for 2 micro-steps; a cli.train child (nf=32) sent SIGTERM
     after its third micro-step must save a checkpoint at its step and
     resume from it, here with trainer.profiler=true (a trace under the run
     dir); and cli.evaluate_mp on phase 6's run dir (-d with two workers,
     N=CHECK_N, files of 5 s), per utterance (one file per worker) and with
     --batch-size EVAL_MP_BATCH on EVAL_MP_FILES files, then one worker the
     same ways (per utterance on half the files), records merged in index
     order, launches exactly PER_EVAL x 2 CHECK_N x
     the sampler runs, seconds per utterance recorded. Every new
     kernel shape of these runs is held against its plain version in bf16.
 11. the DiffuSE recipe (model=diffuse: a 30-layer x 64-channel WaveNet on
     waveforms, float32, no hand kernel): its score and parameter gradients
     at 2 x 5 s on randomized weights, card against CPU with TF32 off
     (DIFFUSE_TOL), one evaluation's device time against its host time;
     cli.train as composed (batch 16 x 5 s, accumulation 2) for
     DIFFUSE_WARMUP + DIFFUSE_TIMED micro-steps with one validation and
     one checkpoint; separate on its EMA weights (N=30 and ddim N=6);
     DIFFUSE_HTTP concurrent requests to the engine cli.serve builds;
     cli.evaluate --test -N 30; cli.distill N=4 -> 2 and the N=2 artifact
     held to the live model; TCN and DPTNet card against CPU. No hand
     kernel may launch in the phase.
 12. the NCSN++ options (OPTION_SETS A-D: DDPM blocks, resample convs,
     residual pyramids, cat, positional embedding, log/none/learnable
     transforms, an uncentered STFT, ...): one evaluation of each at full
     width (2 x 5 s, bf16 where the JAX package's promotions leave it,
     seeded random weights) with its launches held to OPTION_PER_EVAL,
     every new kernel call held against its plain version, device ms, host
     ms and idle share; each set at nf=32 in float32, card against CPU
     (1e-3 of scale) and kernels against plain (2e-5); sets A and C
     separate at N=CHECK_N and ddim N=6 (utt/s, peak); set C through
     cli.export_model (ddim N=ART_N) held to the live separate_masked and
     served by cli.separate --model ARTIFACT; the f32 fallback recipe
     (dtype=float32, remat=true) through cli.train.main at 6 x 5 s for
     F32_WARMUP + F32_TIMED micro-steps with REMAT_PER_STEP launches each
     (the f32 conv's backward on the hand kernels: dx on conv3x3, dw on
     conv3x3_dw), one micro-step's gradients with remat against without
     (REMAT_TOL of the norm) and both peaks, its kernel shapes timed
     (float32 at batch 6, against cuDNN as in phase 3) and summed per
     micro-step, its dx and dw at each of those shapes held to their plain
     versions (BWD_TOL of max |plain|) and timed beside cuDNN's
     convolution_backward and the bound (conv_bound_ms), summed per
     micro-step, and its device time by kernel group under torch.profiler
     (no cuDNN conv kernel in it); each option set's
     micro-step at 2 x 5 s with OPTION_BWD f32 dx and dw launches; and
     the flagship on one 70 s mixture, its
     blockwise attention (4416 tokens) against the naive one (LONG_TOL of
     scale), device ms and peak of each.

 13. this slice's paths: the recipe through cli.train.train on two ranks
     (processes spawned here, gloo on the one card) with
     trainer.strategy=ddp, then fsdp, FSDP_STEPS micro-steps of FSDP_BATCH
     rows each on the same rows: every loss finite, losses and parameters
     within FSDP_TOL of DDP's, launches per micro-step TRAIN_PER_STEP on
     every rank, each rank's parameter, optimizer and EMA bytes and peak
     beside DDP's, the last validation equal to the gathered one-process
     model's (FSDP_TOL), the fsdp checkpoint separating a mixture in one
     process; tensor-parallel separation (make_tp_separate, tp=2 over the
     same two rank processes, after their fits) of one 5 s mixture with ddim + none at TP_N against the
     replicated separation of the same seed (TP_TOL of scale), launches per
     rank exact, seconds per utterance of each; n_speakers=3 at full width,
     one evaluation and a ddim separation, launches exact; every kernel
     shape of these runs that no earlier phase held (the convs at Cout / 2,
     the stem at Cin = 8, the output pyramid's convs at Cout = 8) against its plain
     version in bf16, the tp and three-speaker ones timed; then
     cli.evaluate --save-n on phase 8's run, cli.evaluate_covl on the saved
     wavs (finite CSIG/CBAK/COVL), cli.merge_dnsmos with a DNSMOS CSV
     written here, cli.export_model --torch on phase 6's run (read back bit
     for bit) and --torch --avg-last-k 2 on the fsdp run (its two
     checkpoints' mean, bit for bit).
 14. the last modules of the JAX package: every block of
     models/legacy_layers.py and every normalization variant
     (legacy_blocks) at NCSNv2's CIFAR-10 width (ngf LEGACY_NGF = 128,
     LEGACY_CLASSES = 232 noise scales) in float32 on the flagship's top
     grid at batch 2 (the second MSF/Refine input at 128 x 160 x 256), with
     seeded random weights: each block's conv3x3 launches equal its 3x3
     stride-1 undilated convs (0 for the dilated ones), its output against
     the plain versions on the card (TOL float32 times its hand convs, each
     of which rounds), its device ms, and every conv shape held to TOL
     float32 and timed alone against plain, cuDNN and the bound;
     the same modules at 32 channels on 32 x 40, card against CPU
     (LEGACY_CPU_TOL of scale); cli.figures reverse_diffusion_example on
     phase 6's run dir and its folder's cv split at N = FIG_N with save_fig
     captured (no matplotlib there): intermediates (30, 2, 1, 2, T) finite,
     launches PER_EVAL x 2 FIG_N, the sources bit for bit get_pc_sampler's with
     the same seed, seconds recorded; the C++ WAV decoder
     (data/native_io.py) built there, bit for bit scipy over phase 6's
     folder, the loader at the recipe's batch (6 rows x 3 files) on the
     native path (its counter), host ms per batch against scipy's; and
     fused_leaky_relu and get_score_fn (OUVE, OUVP; continuous and discrete)
     card against CPU;
 15. the separation learning demo (scripts/torch_port_train_demo.py: nf
     32, ch_mult (1, 1, 2), bf16, batch 16 x 1 s at 8 kHz, its data stream
     and seeds) trains DEMO_STEPS steps at seed 0 through the script's loop:
     every loss finite, the mean loss of steps 201-300 below
     DEMO_LOSS_RATIO x that of steps 1-10, DEMO_PER_STEP launches (forward,
     backward) in every step and the same in every window of 100; then the
     script's evaluation of the EMA weights on its 8 held-out mixtures (PC
     N=30, ddim N=6, ddim and dpmpp at N = 4, 6, 8: 102 evaluations, each
     DEMO_PER_STEP's forward launches; the floor 0.00 dB); every conv
     launch of the training that reads 32 or 96 channels ran the
     "slice32" plan (counted by plan); every kernel
     shape of both runs held against its plain version and timed beside
     cuDNN and the bound (each shape's share of it logged), summed per step
     by kernel, by conv plan and by input channels (the stem, Cin 32 and 96,
     both); s per step. Then the distillation of
     scripts/torch_port_distill_demo.py from the EMA weights (its batch
     stream, a fresh batch every step; stages DEMO_DISTILL_STAGES of
     DEMO_DISTILL_STEPS steps on the linear grid): DEMO_DISTILL_PER_STEP
     launches in every step, each student's ddim SI-SDR on the held-out
     set at its N finite, N x DEMO_PER_STEP's forward launches per
     evaluation; every kernel shape of these runs held as those above; s
     per distill step.
 16. the enhancement learning demo (scripts/torch_port_train_demo_nr.py:
     model=nr, PriorMixSDE, init_hack 4, the same widths and grid as phase
     15's at batch 16 x 1 s, 16 kHz) trains NR_STEPS steps at seed 0
     through the script's loop, with phase 15's checks (losses finite, the
     mean loss of the last 100 steps below DEMO_LOSS_RATIO x that of steps
     1-10, NR_PER_STEP launches in every window of 100, every
     Cin 32/96 conv on "slice32"); the noisy floors of its 8 held-out clips
     (SI-SDR and PESQ-wb) at NR_FLOORS; then the distillation of
     scripts/torch_port_distill_demo_nr.py from the EMA weights, stages
     NR_DISTILL_STAGES of NR_DISTILL_STEPS steps each, NR_DISTILL_PER_STEP
     launches in every step, and each student's ddim SI-SDR on the held-out
     clips finite, N x NR_PER_STEP's forward launches per evaluation
     (both phases' distillation is one helper, ``smoke_distill``); every
     kernel shape of these runs that phase 15 did not hold, held against
     its plain version; s per step and per distill step. The times of
     phases 7-16 are read with the other process's phases running on the
     same card.

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
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path
from unittest import mock

import numpy as np

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM dense, tensor cores / CUDA cores
TF32_FLOPS = 495e12  # H100 SXM dense TF32: the "tf32x3" conv does 3 TF32 products per f32 one
HBM_BYTES_PER_S = 3.35e12
SERVE_BATCH, SERVE_SECONDS, FS = 2, 5, 8000
PER_EVAL = {"conv3x3": 106, "fir_down2x": 18, "fir_up2x": 18}  # flagship NCSN++ launches per score evaluation
# a call slower than this is timed over 3 repetitions instead of 5
SLOW_CALL_MS = 50.0
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
# serving entry points: the production sampler's steps and evaluations; an
# HTTP burst of more clients than http.server's default listen backlog (5),
# of seeded lengths in seconds; the fast sampler of the stdin and streaming
# runs; the steps of each new sampler's run
PROD_N, PROD_NFE = 30, 60
# the production sampler (reverse_diffusion + ald2) where a path runs it
# again after phase 5 (the HTTP burst, the enhancement run and its CLIs, the
# DDP fit, cli.evaluate_mp, option sets A and C, the figures CLI): the same
# code at fewer steps, so that the script keeps within its time
CHECK_N, CHECK_NFE = 6, 12
HTTP_CLIENTS, HTTP_BATCH, HTTP_SECONDS = 12, 4, (3, 6)
STDIN_N, STREAM_SECONDS, SAMPLER_N = 6, 20, 4
SAMPLER_CASES = [  # (label, predictor or "ode", corrector, settings)
    ("euler_maruyama+none", "euler_maruyama", "none", {}),
    ("heun+none", "heun", "none", {}),
    ("dpmpp+none", "dpmpp", "none", {}),
    ("reverse_diffusion+langevin", "reverse_diffusion", "langevin", {}),
    ("reverse_diffusion+ald", "reverse_diffusion", "ald", {}),
    ("reverse_diffusion+ald2 denoise=False", "reverse_diffusion", "ald2", {"denoise": False}),
    ("ode_sample rk4", "ode", None, {}),
]
# enhancement (phase 8): synthetic VCTK-DEMAND files (32 train + 4 val
# after the recipe's 90/10 split, so that every micro-step has the batch of
# 4; test; the ones cli.separate enhances), the recipe's batch and the
# micro-steps around the timing (2 optimizer steps at accumulation 4)
ENH_FS, ENH_TRAIN, ENH_TEST, ENH_SEP = 16000, 36, 4, 2
ENH_BATCH, ENH_WARMUP, ENH_TIMED = 4, 2, 6
# distillation (phase 9): the halving schedule from the phase-6 run, steps
# per stage (the first of each untimed), and timed calls of the artifact
DISTILL_STAGES, DISTILL_STEPS, ART_CALLS = (4, 2), 5, 3
# data parallelism (phase 10): ranks, rows per rank (the recipe's 6 in
# all), micro-steps (accumulation 2: 3 optimizer steps) and test files of
# the DDP fit; the nf=32 float32 model of the DDP-vs-one-process updates and
# their tolerance (of the norms); the preempted child's batch and width;
# cli.evaluate_mp's test files and batch
DDP_RANKS, DDP_BATCH, DDP_STEPS, DDP_TEST, DDP_TOL = 2, 3, 6, 2, 1e-3
DDP_SMALL = {"score_model": {"backbone_args": {"nf": 32, "ch_mult": (1, 1, 2, 2), "num_res_blocks": 1,
                                               "dtype": "float32"}}}
PREEMPT_BATCH = 2
PREEMPT_WIDTH = ["model.score_model.backbone_args.nf=32", "model.score_model.backbone_args.ch_mult=[1,1,2,2]",
                 "model.score_model.backbone_args.num_res_blocks=1"]
EVAL_MP_FILES, EVAL_MP_BATCH = 4, 4
# the DiffuSE recipe (phase 11): its published batch (the default
# datamodule's 16 x 5 s) and micro-steps around the timing, test files,
# concurrent HTTP requests, distill steps per stage, back-to-back
# evaluations of the host-vs-device reading; tolerances of the card against
# the CPU in float32 with TF32 off (score: of its scale; gradients: max
# |difference| over the global norm), also those of TCN and DPTNet
DIFFUSE_BATCH, DIFFUSE_WARMUP, DIFFUSE_TIMED, DIFFUSE_TEST = 16, 2, 8, 4
DIFFUSE_HTTP, DIFFUSE_DISTILL_STEPS, DIFFUSE_EVALS = 6, 3, 10
DIFFUSE_TOL = {"score": 1e-4, "grad": 1e-3}
# the NCSN++ option sets of phase 12, (backbone_args, frontend) over the
# flagship's (nf=128, 7 levels, 2 res blocks, attention at 16, bf16): A after
# the DDPM++ settings of score_sde (configs/vp/cifar10_ddpmpp_continuous.py),
# B after its VE NCSN++ (configs/ve/cifar10_ncsnpp_continuous.py), C and D
# the remaining options. A's log transform takes the JAX class's default
# factor, 3: its inverse exp(|X| / factor) would overflow at the flagship's
# 0.15 on unit-scale random weights. Their hand-kernel launches per score
# evaluation; the sets separated at N=30 and ddim N=6; back-to-back
# evaluations of the host-vs-device reading; the nf=32 float32 copy of each
OPTION_SETS = {
    "A": ({"fir": False, "progressive": "none", "progressive_input": "none", "embedding_type": "positional",
           "scale_by_sigma": False}, {"transform": "log", "spec_factor": 3.0}),
    "B": ({"progressive_input": "residual"}, {"spec_trans_learnable": True}),
    "C": ({"resblock_type": "ddpm", "progressive": "residual", "progressive_input": "input_skip",
           "progressive_combine": "cat", "centered": True}, {"transform": "none", "stft_args": {"center": False}}),
    "D": ({"resblock_type": "ddpm", "fir": False, "progressive": "none", "progressive_input": "none",
           "conditional": False, "nonlinearity": "elu", "skip_rescale": False}, {}),
}
OPTION_PER_EVAL = {"A": {"conv3x3": 100}, "B": {"conv3x3": 106, "fir_down2x": 12, "fir_up2x": 18},
                   "C": {"conv3x3": 77, "fir_down2x": 6}, "D": {"conv3x3": 82}}
OPTION_SEPARATE, OPTION_EVALS = ("A", "C"), 3
SMALL_BACKBONE = {"nf": 32, "ch_mult": (1, 1, 2, 2), "num_res_blocks": 1, "dtype": "float32"}
# set C's artifact: ddim steps; the f32 fallback recipe (float32, remat) at
# 6 x 5 s: micro-steps around the timing; its launches per micro-step
# (forward, backward): remat runs each residual and attention block's
# forward again in the backward (98 of the 106 convs, the 12 in-block FIR
# downs and 12 ups); each f32 conv's backward is a dx on conv3x3 (105: the
# stem's input takes no gradient) and a dw on conv3x3_dw (106); remat
# against no remat, of the gradient norm; dx and dw against their plain
# versions, of max |plain|
ART_N = 4
F32_WARMUP, F32_TIMED = 1, 3
REMAT_PER_STEP = {"conv3x3": (204, 105), "conv3x3_dw": (0, 106), "fir_down2x": (30, 18), "fir_up2x": (30, 12)}
REMAT_TOL, BWD_TOL = 1e-6, 2e-5
# each option set's micro-step at 2 x 5 s: its float32 convs' dx and dw
# launches (the JAX package's promotions leave these convs in f32; B's
# learnable transform gives its stem's input a gradient)
OPTION_BWD = {"A": (1, 1), "B": (92, 92), "C": (31, 31), "D": (77, 77)}
# blockwise attention: the flagship on one 70 s mixture (4416 tokens at the
# attention level, past the 4096 threshold), blockwise against naive in
# float32, of the score's scale
LONG_SECONDS, LONG_TOL = 70, 1e-4
# phase 13: the FSDP fit (micro-steps of FSDP_BATCH rows per rank on phase
# 6's 12 files: two epochs, each with a validation and a checkpoint; its
# validation samples at FSDP_VAL_N) against DDP on the same rows, held to
# FSDP_TOL (losses relative, parameters of their norm, the validation
# against the gathered model's relative); the ddim steps of the
# tensor-parallel, three-speaker and FSDP-checkpoint separations, tp=2
# against the replicated separation (of scale: bf16, the split convs take
# other plans); the utterances cli.evaluate saves for evaluate_covl
FSDP_STEPS, FSDP_BATCH, FSDP_VAL_N = 4, 3, 4
FSDP_TOL = {"loss": 1e-3, "params": 1e-4, "validation": 1e-4}
TP_N, TP_TOL, TOOLS_SAVE_N = 6, 1e-2, 2
# phase 14: the legacy blocks at NCSNv2's CIFAR-10 width (ngf 128) and
# number of noise scales (232 classes), float32, on the flagship's top grid
# at batch 2 (the second MSF/Refine input at half the grid and twice the
# width); the width and grid of their card-vs-CPU check and its tolerance
# (of scale); the figure's sampler steps
LEGACY_NGF, LEGACY_CLASSES, LEGACY_BATCH, LEGACY_GRID = 128, 232, 2, (256, 320)
LEGACY_SMALL, LEGACY_CPU_TOL, FIG_N = (32, (32, 40)), 1e-3, CHECK_N
# phase 15: the separation learning demo at seed 0: its steps, and the bar on
# its windowed mean losses (steps 201-300 against 1-10: the per-step loss is
# noisy); its launches per step (forward, backward): conv 34 = stem + 2 x
# 15 BigGAN blocks + 3 output-pyramid convs; FIR 6 downs (4 in blocks, 2 of
# the input pyramid) and 6 ups, whose backward is a down for every up and an
# up for every in-block down
DEMO_STEPS, DEMO_LOSS_RATIO = 300, 0.7
DEMO_PER_STEP = {"conv3x3": (34, 0), "fir_down2x": (6, 6), "fir_up2x": (6, 4)}
# then the distillation from its EMA weights: stages, steps per stage, and
# the launches per step: the teacher's two substeps and the student's
# forward, one backward
DEMO_DISTILL_STAGES, DEMO_DISTILL_STEPS = (4, 2), 5
DEMO_DISTILL_PER_STEP = {k: (3 * f, b) for k, (f, b) in DEMO_PER_STEP.items()}
# phase 16: the enhancement learning demo at seed 0, its steps (the bar of
# phase 15 on the mean loss of its last 100 steps: the recipe's loss holds
# near 0.85 of its start through about step 250, steps 201-300 at 0.750 of
# steps 1-10 at seed 0, 301-400 at 0.471); its launches per step are phase
# 15's (the same widths on the same 256 x 128 grid); the
# noisy floors of its held-out set (SI-SDR dB, PESQ-wb; a check on the data
# and the metrics) and their tolerance; the distillation from its EMA weights:
# stages, steps per stage, a pool of batches cycled, and its launches per
# step: the teacher's two substeps and the student's forward, one backward
NR_STEPS, NR_PER_STEP = 400, DEMO_PER_STEP
NR_FLOORS = {"si_sdr_noisy_floor_db": (8.98, 0.01), "pesq_wb_noisy_floor": (1.882, 0.001)}
NR_DISTILL_STAGES, NR_DISTILL_STEPS, NR_DISTILL_POOL = (4, 2), 5, 4
NR_DISTILL_PER_STEP = DEMO_DISTILL_PER_STEP
# device time by kernel name fragment (torch.profiler's kernel names)
# (cuDNN's conv kernels are named by their pass, fprop, dgrad or wgrad;
# cuBLAS's sm80_xmma_gemm_* fall under GEMMs)
OPTION_GROUPS = (("hand conv3x3 dw", ("conv3x3_dw",)), ("hand conv3x3", ("conv3x3",)), ("hand FIR", ("fir2x",)),
                 ("cuDNN convs", ("fprop", "dgrad", "wgrad", "cudnn", "implicit_convolve", "conv2d")),
                 ("GEMMs", ("gemm", "Gemm")))
# the framework's convolution ops whose calls busy_and_host_ms counts: the f32
# + remat micro-step's conv backward runs on the hand kernels, none of these
FRAMEWORK_CONV_OPS = ("aten::convolution", "aten::convolution_backward")
RECORD_KEYS = {"batch_idx", "si_sdr", "si_sir", "si_sar", "pesq", "stoi", "nfe", "runtime", "len_s"}
# odd-sized FIR downs whose backward is the pads-(2, 2) up (repair F1), and
# resampling calls that no kernel serves, run plain on the card (F2)
ODD_FIR_SHAPES = [(1, 7, 10, 8), (1, 8, 9, 8), (2, 63, 95, 64), (1, 127, 129, 6)]
PLAIN_RESAMPLE_CASES = [  # (label, up, kernel, factor, data_format, shape)
    ("up factor 4, [1,3,3,1]", True, [1, 3, 3, 1], 4, "NHWC", (2, 16, 24, 32)),
    ("down 2-D kernel", False, [[1, 2, 1], [2, 4, 2], [1, 2, 1]], 2, "NHWC", (2, 32, 48, 16)),
    ("up NCHW", True, [1, 3, 3, 1], 2, "NCHW", (2, 16, 32, 24)),
]
KERNELS = {
    "conv3x3": dict(source="diffsep_tpu_torch/csrc/conv3x3.cu",
                    replaces="diffsep_tpu/ops/pallas/conv3x3.py:75"),
    "fir_down2x": dict(source="diffsep_tpu_torch/csrc/fir_resample2x.cu",
                       replaces="diffsep_tpu/ops/pallas/upfirdn.py:94"),
    "fir_up2x": dict(source="diffsep_tpu_torch/csrc/fir_resample2x.cu",
                     replaces="diffsep_tpu/ops/pallas/upfirdn.py:130"),
}
# the f32 conv's weight gradient replaces no TPU kernel: the JAX package takes
# it from XLA's VJP in conv3x3_mxu's backward
DW_KERNEL = dict(source="diffsep_tpu_torch/csrc/conv3x3.cu", replaces="diffsep_tpu/ops/pallas/conv3x3.py:200")


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
    """Median device time of one call, over 5 repetitions (3 where a call
    takes over SLOW_CALL_MS: cuDNN's float32 convs take up to 0.4 s at some
    flagship shapes). 1 to 20 calls, about 5 ms of work (one where a call
    takes longer), are queued behind a device-side sleep that outlasts
    their enqueueing on the host, so they run back to back between one pair
    of CUDA events: the host's launch overhead stays out of the reading even
    where one call is shorter than its enqueueing."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    probe_ms = (time.perf_counter() - t0) * 1e3
    launches = max(1, min(20, int(5.0 / probe_ms)))
    if probe_ms > SLOW_CALL_MS:  # one call, its enqueueing a sliver of its run
        reps, sleep_cycles = 3, int(1.0 * cycles_per_ms)
    else:
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        reps, sleep_cycles = 5, int(min(3 * enqueue_ms + 1.0, 100.0) * cycles_per_ms)
    times = []
    for _ in range(reps):
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
            if name.endswith(".W") and p.ndim == 1 or p.ndim == 0:
                continue  # the Fourier projection and the transform's learnable constants keep their init
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=g) / (p.numel() / p.shape[0]) ** 0.5)
            else:
                p.add_(0.1 * torch.randn(p.shape, generator=g))


def check_kernel(kind, shape, cout, dtype_name, dev, seed, cycles_per_ms, timed=True):
    """Kernel vs plain on one shape: error, times (None unless ``timed``),
    bound. The kernel runs without grad mode, as serving runs it (the
    "tf32x3" conv keeps its split weight). A float32 conv also gets its
    library call timed twice, with cudnn.benchmark off (the heuristic's
    algorithm, ``library_heuristic_ms``) and on (the fastest of cuDNN's,
    ``library_benchmark_ms``; ``library_ms`` is the better of the two), the
    bound at the FFMA peak and of three TF32 products (``bound_ffma_ms``,
    ``bound_3xtf32_ms``; ``bound_ms`` is the plan's, conv_bound_ms), and,
    on the "tf32x3" plan, its weight split kernel held bit for bit to its
    plain version and timed alone (``split_ms``: once per call in grad
    mode)."""
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
    with torch.no_grad():
        got = kern()
    want, lib = plain(), library()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    lib_err = (got.float() - lib.permute(0, 2, 3, 1).float()).abs().max().item()
    if kind == "conv3x3":
        bound = conv_bound_ms(flops, nbytes, dtype_name, plan["variant"])
    else:  # the FIR's multiply-adds run on the CUDA cores in either dtype
        t_ops, t_bytes = flops / PEAK_FLOPS["float32"] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        bound = dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                     ops_ms=t_ops, bytes_ms=t_bytes)
    row = dict(
        kernel=kind, shape=list(shape), cout=cout, dtype=dtype_name, plan=plan,
        max_abs_err=err, tol=TOL[dtype_name] * scale, ok=err <= TOL[dtype_name] * scale,
        library_abs_err=lib_err, ms=None, plain_ms=None, library_ms=None, **bound,
    )
    f32_conv = kind == "conv3x3" and dtype_name == "float32"
    if plan.get("variant") == "tf32x3":
        split = conv_mod.tf32_split_weight(wt)
        row["split_exact"] = torch.equal(split.view(torch.int32), conv_mod.tf32_split_weight_plain(wt).view(torch.int32))
        row["ok"] = row["ok"] and row["split_exact"]
    if timed:
        with torch.no_grad():
            ms = time_ms(kern, cycles_per_ms)
        library_ms = time_ms(library, cycles_per_ms)
        row.update(ms=ms, plain_ms=time_ms(plain, cycles_per_ms), library_ms=library_ms,
                   tflops=flops / ms / 1e9)
        if f32_conv:
            prev = torch.backends.cudnn.benchmark
            torch.backends.cudnn.benchmark = True
            try:
                tuned = time_ms(library, cycles_per_ms)
            finally:
                torch.backends.cudnn.benchmark = prev
            row.update(library_heuristic_ms=library_ms, library_benchmark_ms=tuned, library_ms=min(library_ms, tuned))
        if "split_exact" in row:
            row["split_ms"] = time_ms(lambda: conv_mod.tf32_split_weight(wt), cycles_per_ms)
        row["ms_per_library_ms"] = ms / row["library_ms"]
    return row


def conv_bound_ms(flops, nbytes, dtype_name, variant):
    """The least time for a conv's work: the larger of its bytes
    over HBM's rate and its operations over the peak of the units its plan
    runs on: three TF32 products on the "tf32x3" plan, else the dtype's
    (bf16's tensor cores, the FFMA units for float32). A float32 conv also
    gets both of its float32 figures, at the FFMA peak and as three TF32
    products (``bound_ffma_ms``, ``bound_3xtf32_ms``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ffma, t_3xtf32 = flops / PEAK_FLOPS[dtype_name] * 1e3, 3 * flops / TF32_FLOPS * 1e3
    t_ops = t_3xtf32 if variant == "tf32x3" else t_ffma
    out = dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
               ops_ms=t_ops, bytes_ms=t_bytes)
    if dtype_name == "float32":
        out.update(bound_ffma_ms=max(t_ffma, t_bytes), bound_3xtf32_ms=max(t_3xtf32, t_bytes))
    return out


def conv_bwd_case(shape, cout, dtype_name, dev, seed):
    """One conv's backward at x ``shape`` -> ``cout`` in ``dtype_name``:
    random x, HWIO weight ``wt`` and dy from ``seed``; ``library(part)``,
    cuDNN's convolution_backward for that gradient alone ("dx" or "dw");
    ``plans``, the port's plan of each (a float32 dx is conv3x3_dx's, a
    bf16 one the forward kernel's on dy with the flipped weight; a bf16 dw
    has none, cuDNN computes it); ``bounds``, each gradient's
    conv_bound_ms, its bytes x, dy and the weight read or written once."""
    import torch

    from diffsep_tpu_torch.ops import conv3x3 as conv_mod

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device=dev).manual_seed(seed)
    b, h, w, c = shape
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    wt = (torch.randn((3, 3, c, cout), generator=g, device=dev) / (9 * c) ** 0.5).to(dtype)
    dy = torch.randn((b, h, w, cout), generator=g, device=dev).to(dtype)
    w_lib = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    lib_args = (dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w_lib, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1)
    masks = {"dx": [True, False, False], "dw": [False, True, False]}

    def library(part):
        return torch.ops.aten.convolution_backward(*lib_args, masks[part])

    if dtype == torch.float32:
        plans = {"dx": conv_mod.plan_conv3x3_dx(b, h, w, c, cout), "dw": conv_mod.plan_conv3x3_dw(b, h, w, c, cout)}
    else:
        plans = {"dx": conv_mod.plan_conv3x3(b, h, w, cout, c, dtype), "dw": None}
    flops = 2.0 * b * h * w * 9 * c * cout
    nbytes = (x.numel() + dy.numel() + wt.numel()) * x.element_size()
    bounds = {part: conv_bound_ms(flops, nbytes, dtype_name, p.variant if p else None) for part, p in plans.items()}
    return types.SimpleNamespace(x=x, wt=wt, dy=dy, library=library, plans=plans, bounds=bounds)


def check_conv_bwd(shape, cout, dev, seed, cycles_per_ms):
    """The float32 conv's backward at x ``shape`` -> ``cout`` (conv_bwd_case):
    dx (conv3x3_dx, a conv3x3 launch) and dw (conv3x3_dw) each against its
    plain version (BWD_TOL of max |plain|), timed beside it and beside
    cuDNN's convolution_backward for that gradient alone (TF32 off,
    cudnn.deterministic on as the recipe trains), with its plan's bound.
    Returns the dx row and the dw row."""
    import torch

    from diffsep_tpu_torch.ops import conv3x3 as conv_mod

    case = conv_bwd_case(shape, cout, "float32", dev, seed)
    x, wt, dy = case.x, case.wt, case.dy
    rows = []
    for part, kern, plain in (
            ("dx", lambda: conv_mod.conv3x3_dx(dy, wt), lambda: conv_mod.conv3x3_dx_plain(dy, wt)),
            ("dw", lambda: conv_mod.conv3x3_dw(x, dy), lambda: conv_mod.conv3x3_dw_plain(x, dy))):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            library_ms = time_ms(lambda part=part: case.library(part), cycles_per_ms)
        finally:
            torch.backends.cudnn.deterministic = prev
        p = case.plans[part]
        rows.append(dict(
            kernel="conv3x3" if part == "dx" else "conv3x3_dw", part=part, shape=list(shape), cout=cout,
            dtype="float32", plan=dict(variant=p.variant, bm=p.bm, bn=p.bn, stages=p.stages, splits=p.splits),
            max_abs_err=err, rel_err=err / scale, tol=BWD_TOL * scale, ok=err <= BWD_TOL * scale,
            ms=time_ms(kern, cycles_per_ms), plain_ms=time_ms(plain, cycles_per_ms), library_ms=library_ms,
            **case.bounds[part]))
    return rows


BWD_SUM_KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_ffma_ms", "bound_3xtf32_ms", "ops_ms", "bytes_ms")


def bwd_group(row):
    """The group a backward row is summed in beside its plan: the plan's
    variant, a "window" dw apart for the output convs (Cout <= 8) and the
    stem (Cin <= 8)."""
    variant = row["plan"]["variant"]
    if variant != "window":
        return variant
    return "window, Cout <= 8" if row["cout"] <= row["shape"][3] else "window, Cin <= 8"


def bwd_sums(rows):
    """The backward rows of ``check_conv_bwd`` summed over their launches per
    micro-step, for dx and for dw: launches, hand ms by plan, plain, cuDNN,
    the bound by plan (``bound_ms``, ``bound_by``) and both float32
    figures; and by group (``bwd_group``) the launches, hand ms, cuDNN ms
    and bound ms, so that each plan is held to cuDNN on its own shapes."""
    out = {}
    for part in ("dx", "dw"):
        mine = [r for r in rows if r["part"] == part]
        by_plan = collections.defaultdict(float)
        by_group = collections.defaultdict(lambda: dict(launches=0, ms=0.0, library_ms=0.0, bound_ms=0.0))
        for r in mine:
            n = r["launches_per_micro_step"]
            by_plan[r["plan"]["variant"]] += r["ms"] * n
            group = by_group[bwd_group(r)]
            group["launches"] += n
            for key in ("ms", "library_ms", "bound_ms"):
                group[key] += r[key] * n
        v = {key: sum(r[key] * r["launches_per_micro_step"] for r in mine) for key in BWD_SUM_KEYS}
        out[part] = dict(launches=sum(r["launches_per_micro_step"] for r in mine), ms_by_plan=dict(by_plan), **v,
                         by_group={k: dict(g) for k, g in by_group.items()},
                         bound_by="operations" if v["ops_ms"] >= v["bytes_ms"] else "bytes",
                         max_rel_err=max(r["rel_err"] for r in mine))
    return out


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


def counting_train_step(per_step, snapshots=None):
    """A stand-in for ``DiffSepModel.make_train_step`` whose train step
    appends each micro-step's launches (all and backward), kernel shapes,
    batch shape and the peak memory after it to ``per_step``; and, where
    ``snapshots`` is a list, a copy of the parameters on the card after
    every applied optimizer step (hashed after the run by
    ``params_digest``, so that no micro-step waits for it; the peak
    leaves the copies out)."""
    import torch

    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.ops import _build

    make_train_step = DiffSepModel.make_train_step

    def counted_train_step(self, seed, forward=None):
        train_step = make_train_step(self, seed, forward=forward)

        def run(state, mix, target, *args, **kwargs):
            before = [collections.Counter(c) for c in
                      (_build.launch_counts, _build.backward_counts, _build.launch_shapes)]
            metrics = train_step(state, mix, target, *args, **kwargs)
            after = (_build.launch_counts, _build.backward_counts, _build.launch_shapes)
            launches, backward, shapes = (collections.Counter(a) - b for a, b in zip(after, before))
            kept = sum(t.numel() * t.element_size() for t in snapshots or [])
            peak = torch.cuda.max_memory_allocated() - kept if mix.is_cuda else 0
            per_step.append(dict(launches=dict(launches), backward=dict(backward), shapes=shapes,
                                 batch=list(mix.shape), peak_gib=peak / 2**30))
            if snapshots is not None and state.optimizer.mini_step == 0:
                with torch.no_grad():
                    snapshots.append(torch.cat([p.detach().reshape(-1).float() for p in state.params]))
            return metrics

        return run

    return counted_train_step


def params_digest(flat):
    """sha256 of a flat parameter copy's bytes (copied to the host)."""
    import hashlib

    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def train_speed(run_dir, warmup, timed, batch):
    """ms per micro-step, micro-steps/s and samples/s of a run of cli.train:
    the host clock from the start of micro-step ``warmup + 1`` to the
    synchronize that ends the epoch (train_log.jsonl); and the log's rows."""
    records = [json.loads(line) for line in (Path(run_dir) / "train_log.jsonl").read_text().splitlines()]
    rows = [r for r in records if "step" in r]
    start = next(r["start_s"] for r in rows if r["step"] == warmup + 1)
    end = [r["synced_s"] for r in records if "synced_s" in r][-1]
    ms = (end - start) * 1e3 / timed
    return dict(ms_per_micro_step=ms, micro_steps_per_s=1e3 / ms, samples_per_s=batch * 1e3 / ms), rows


def train_phase(dev, card, cycles_per_ms, rng, tmp, extra_overrides=()):
    """Phase 6: the recipe trains through its entry point, in the directory
    ``tmp``; see the module docstring. ``extra_overrides`` go to the entry
    point after the phase's own. Returns the phase's report, with the run
    dir it wrote under "run_dir"."""
    import torch

    from diffsep_tpu_torch.cli import train as train_cli
    from diffsep_tpu_torch.data.audio_io import load_wav
    from diffsep_tpu_torch.data.synthetic import write_wsj0_mix
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.models import layers
    from diffsep_tpu_torch.ops import _build
    from diffsep_tpu_torch.ops.plain import plain_kernels
    from diffsep_tpu_torch.train.checkpoints import load_payload

    out = {}
    steps = TRAIN_WARMUP + TRAIN_TIMED
    per_step = []

    data = write_wsj0_mix(Path(tmp) / "wsj0_mix", {"train": 2 * TRAIN_BATCH, "val": 5},
                          seconds=SERVE_SECONDS, fs=FS, seed=0)
    overrides = ["experiment=icassp-separation", f"path.datasets.wsj0_mix={data}",
                 f"path.exp_root={tmp}/exp", f"trainer.max_steps={steps}", "model.valid_max_sep_batches=1",
                 *extra_overrides]
    log(f"[train] python -m diffsep_tpu_torch.cli.train {' '.join(overrides)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    t0 = time.perf_counter()
    with mock.patch.object(DiffSepModel, "make_train_step", counting_train_step(per_step)):
        state = train_cli.main(overrides)
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    out["launches"] = dict(_build.launch_counts)
    out["backward_launches"] = dict(_build.backward_counts)
    run_dir = next(Path(tmp, "exp").glob("*/*/train_log.jsonl")).parent
    out["run_dir"] = str(run_dir)
    index = json.loads((run_dir / "checkpoints" / "index.json").read_text())
    val = index[str(steps)]
    assert state.step == steps and len(per_step) == steps, (state.step, len(per_step))

    speed, rows = train_speed(run_dir, TRAIN_WARMUP, TRAIN_TIMED, TRAIN_BATCH)
    ms = speed["ms_per_micro_step"]
    out.update(
        batch=per_step[0]["batch"], **speed, peak_gib=max(s["peak_gib"] for s in per_step),
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
    assert all(counts["kernels"][1].get(k, 0) > 0 for k in ("fir_down2x", "fir_up2x", "conv3x3", "conv3x3_dw")), \
        counts
    assert not counts["plain"][0], counts
    return out


def check_odd_fir_backward(dev, seed):
    """The backward of a FIR down on odd sizes (the up with pads (2, 2) on
    the odd axis, "direct" variant) on the card against its plain version
    on the same gradient, float32 and bfloat16."""
    import torch

    from diffsep_tpu_torch.ops import _build
    from diffsep_tpu_torch.ops import fir_resample2x as fir_mod

    taps = (0.125, 0.375, 0.375, 0.125)
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for shape, dtype_name in itertools.product(ODD_FIR_SHAPES, ("float32", "bfloat16")):
        dtype = getattr(torch, dtype_name)
        x = torch.randn(shape, generator=g, device=dev).to(dtype).requires_grad_()
        y = fir_mod.fir_down2x(x, taps)
        grad = torch.randn(y.shape, generator=g, device=dev).to(dtype)
        _build.reset_counts()
        y.backward(grad)
        torch.cuda.synchronize()
        counts = dict(_build.backward_counts)
        extra = (shape[1] % 2, shape[2] % 2)
        want = fir_mod.fir_up2x_plain(grad, taps[::-1], extra)
        err = (x.grad.float() - want.float()).abs().max().item()
        scale = max(1.0, want.float().abs().max().item())
        plan = fir_mod.plan_fir2x(*grad.shape, dtype, True, True, extra)
        rows.append(dict(shape=list(shape), dtype=dtype_name, grad_shape=list(x.grad.shape), plan=plan.variant,
                         backward_launches=counts, max_abs_err=err, tol=TOL[dtype_name] * scale,
                         ok=err <= TOL[dtype_name] * scale and tuple(x.grad.shape) == shape
                         and counts == {"fir_up2x": 1}))
    return rows


def check_plain_resampling(dev, seed):
    """Resampling calls that no kernel serves (another factor, a 2-D filter,
    NCHW data) run the plain upfirdn2d on the card: float32, against the
    CPU, and no kernel launches."""
    import torch

    from diffsep_tpu_torch.ops import _build
    from diffsep_tpu_torch.ops.resampling import downsample_2d, upsample_2d

    g = torch.Generator().manual_seed(seed)
    rows = []
    for label, up, k, factor, fmt, shape in PLAIN_RESAMPLE_CASES:
        x = torch.randn(shape, generator=g)
        fn = upsample_2d if up else downsample_2d
        _build.reset_counts()
        got = fn(x.to(dev), k, factor=factor, data_format=fmt)
        torch.cuda.synchronize()
        launched = dict(_build.launch_counts)
        want = fn(x, k, factor=factor, data_format=fmt)
        err = (got.cpu() - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        rows.append(dict(case=label, shape=list(shape), out_shape=list(got.shape), max_abs_err=err,
                         tol=TOL["float32"] * scale, launches=launched,
                         ok=err <= TOL["float32"] * scale and not launched and got.shape == want.shape))
    return rows


def envelope_float64(mix, avg_len):
    """PriorMixSDE's envelope of ``mix`` (numpy) in float64: 0.5 sqrt of the
    zero-padded moving average of mix^2, the 1e-4 clamp included."""
    k, p, n = avg_len, avg_len // 2, mix.shape[-1]
    cs = np.cumsum(np.pad(mix.astype(np.float64) ** 2, [(0, 0)] * (mix.ndim - 1) + [(p + 1, p)]), axis=-1)
    win = (cs[..., k:k + n] - cs[..., :n]) / k
    return 0.5 * np.sqrt(np.maximum(win, 1e-4))


def enhance_phase(dev, card, cycles_per_ms, tmp, small_pair, checked):
    """Phase 8: the enhancement recipe through its entry points; see the
    module docstring. ``small_pair`` is the model phase's nf=32 float32
    models (card, CPU), ``checked`` the (kernel, shape, cout) keys earlier
    phases held against the plain versions in bf16. Returns (report,
    launches over the phase's main-path runs)."""
    import logging
    import shutil

    import torch

    from diffsep_tpu_torch.cli import evaluate as eval_cli
    from diffsep_tpu_torch.cli import separate as sep_cli
    from diffsep_tpu_torch.cli import train as train_cli
    from diffsep_tpu_torch.data.audio_io import load_wav
    from diffsep_tpu_torch.data.synthetic import write_vctk_demand
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.ops import _build
    from diffsep_tpu_torch.sampling import pc_sample
    from diffsep_tpu_torch.sde import PriorMixSDE

    out, total, shapes = {}, collections.Counter(), collections.Counter()
    warned = []  # the package's warnings: PESQ items dropped, validation metrics that failed

    class Grab(logging.Handler):
        def emit(self, record):
            warned.append(record.getMessage())

    grab = Grab(level=logging.WARNING)
    logging.getLogger("diffsep_tpu_torch").addHandler(grab)

    def counted(label, want):
        torch.cuda.synchronize()
        got = dict(_build.launch_counts)
        total.update(got)
        shapes.update(_build.launch_shapes)
        assert got == want, (label, got, want)
        return got

    def check_records(path, n_src):
        records = json.loads(path.read_text())
        summary = json.loads(path.with_name(path.stem + "_summary.json").read_text())
        assert records and all(set(r) == RECORD_KEYS for r in records), records[:1]
        assert set(summary) == RECORD_KEYS | {"number"} and summary["number"] == len(records), summary
        for r in records:
            assert len(r["si_sdr"]) == 1 and len(r["si_sdr"][0]) == n_src, r["si_sdr"]  # nested [[...]]
            assert np.isfinite(r["si_sdr"]).all() and np.isfinite(r["stoi"]).all(), r
        return records, summary

    data = write_vctk_demand(Path(tmp) / "vctk_demand", ENH_TRAIN, ENH_TEST, fs=ENH_FS, seed=0)
    steps = ENH_WARMUP + ENH_TIMED
    overrides = ["experiment=noise-reduction", f"path.datasets.valentini={data}", f"path.exp_root={tmp}/exp_nr",
                 f"trainer.max_steps={steps}", "trainer.check_val_every_n_epoch=100", "test=true",
                 f"model.sampler.N={CHECK_N}"]
    log(f"[enhance] python -m diffsep_tpu_torch.cli.train {' '.join(overrides)}")
    per_step = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    t0 = time.perf_counter()
    with mock.patch.object(DiffSepModel, "make_train_step", counting_train_step(per_step)):
        state = train_cli.main(overrides)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run_dir = next(Path(tmp, "exp_nr").glob("*/*/train_log.jsonl")).parent
    val = json.loads((run_dir / "checkpoints" / "index.json").read_text())[str(steps)]
    speed, rows = train_speed(run_dir, ENH_WARMUP, ENH_TIMED, ENH_BATCH)
    test_records, test_summary = check_records(run_dir / "test_results" / "test.json", 2)
    assert state.step == steps and len(per_step) == steps, (state.step, len(per_step))
    assert all(s["batch"] == [ENH_BATCH, 1, 3 * ENH_FS] for s in per_step), [s["batch"] for s in per_step]
    losses, norms = [r["train/score_loss"] for r in rows], [r["grad/norm"] for r in rows]
    assert all(np.isfinite(losses)) and all(np.isfinite(norms)), losses
    want = {k: sum(v) for k, v in TRAIN_PER_STEP.items()}
    want_bwd = {k: v[1] for k, v in TRAIN_PER_STEP.items() if v[1]}
    for st in per_step:
        assert st["launches"] == want and st["backward"] == want_bwd, (st["launches"], st["backward"])
    pesq_failed = [m for m in warned if "val metric val/pesq failed" in m]
    assert np.isfinite(val["val/score_loss"]) and np.isfinite(val["val/si_sdr"]), val
    assert "val/pesq" in val or pesq_failed, (val, warned)
    # the run's evaluations: the validation's score loss (1 batch), its
    # separation (CHECK_NFE) and the test split's
    evals = 1 + CHECK_NFE + sum(r["nfe"] for r in test_records)
    counted("cli.train", {k: steps * want[k] + v * evals for k, v in PER_EVAL.items()})
    train_shapes = per_step[-1]["shapes"]
    out["train"] = dict(
        run_s=run_s, batch=per_step[0]["batch"], **speed, peak_gib=max(st["peak_gib"] for st in per_step),
        losses=losses, grad_norms=norms, validation=val,
        per_step=[dict(launches=st["launches"], backward=st["backward"]) for st in per_step],
        test_summary=test_summary, test_s_per_utterance=float(np.mean([r["runtime"] for r in test_records])))
    log(f"[enhance] {steps} micro-steps of batch {per_step[0]['batch']} with validation, checkpoint and the "
        f"test split in {run_s:.1f} s; timed {ENH_TIMED} after {ENH_WARMUP}: {speed['ms_per_micro_step']:.2f} ms "
        f"per micro-step, {speed['samples_per_s']:.3f} samples/s, peak {out['train']['peak_gib']:.2f} GiB ({card})")
    for r in rows:
        log(f"[enhance] micro-step {r['step']}: loss {r['train/score_loss']:.6g} grad norm {r['grad/norm']:.6g}")
    log(f"[enhance] validation: {val}; launches per micro-step {per_step[-1]['launches']}, of them backward "
        f"{per_step[-1]['backward']}")
    log(f"[enhance] test=true: {len(test_records)} utterances, {out['train']['test_s_per_utterance']:.3f} s per "
        f"utterance (sampler, N={CHECK_N}); summary {test_summary}")

    # cli.evaluate --enhance on the run dir
    eval_out = Path(tmp) / "eval_nr"
    _build.reset_counts()
    t0 = time.perf_counter()
    eval_cli.main([str(run_dir), "--enhance", "--test", "--save-n", "0", "-o", str(eval_out)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    (res_dir,) = eval_out.iterdir()
    records, summary = check_records(res_dir / "test.json", 1)
    got = counted("cli.evaluate", launches_of(sum(r["nfe"] for r in records)))
    out["evaluate"] = dict(seconds=secs, utterances=len(records), dir=res_dir.name, summary=summary, launches=got,
                           s_per_utterance=float(np.mean([r["runtime"] for r in records])),
                           wall_s_per_utterance=secs / len(records),
                           pesq_nan=sum(not np.isfinite(r["pesq"]).all() for r in records))
    log(f"[enhance] cli.evaluate RUN_DIR --enhance --test --save-n 0: {len(records)} utterances in {secs:.1f} s "
        f"with loading, {out['evaluate']['s_per_utterance']:.3f} s per utterance in the sampler ({card}); "
        f"{res_dir.name}; summary {summary}")

    # cli.separate on a folder of 16 kHz noisy files
    sep_in, sep_out = Path(tmp) / "noisy16k", Path(tmp) / "enhanced"
    sep_in.mkdir()
    noisy = sorted((data / "test" / "noisy").iterdir())[:ENH_SEP]
    for f in noisy:
        shutil.copy(f, sep_in / f.name)
    _build.reset_counts()
    t0 = time.perf_counter()
    sep_cli.main([str(sep_in), str(sep_out), "--model", str(run_dir), "-N", str(CHECK_N)])
    secs = time.perf_counter() - t0
    got = counted("cli.separate", launches_of(CHECK_NFE, ENH_SEP))
    for f in noisy:
        n = load_wav(f)[0].shape[-1]
        for src in range(2):
            est, fs = load_wav(sep_out / f"s{src}" / f.name)
            assert fs == ENH_FS and est.shape == (1, n) and np.isfinite(est).all(), (f.name, est.shape)
    out["separate"] = dict(files=len(noisy), seconds=secs, launches=got)
    log(f"[enhance] cli.separate IN OUT --model RUN_DIR -N {CHECK_N}: {len(noisy)} files of 16 kHz, speech and "
        f"noise at their own length, finite, {secs:.1f} s")
    logging.getLogger("diffsep_tpu_torch").removeHandler(grab)
    out["warnings"] = warned
    out["pesq_failures"] = dict(validation=len(pesq_failed), items_dropped=[m for m in warned if "PESQ dropped" in m],
                                test_nan=sum(not np.isfinite(r["pesq"]).all() for r in test_records),
                                evaluate_nan=out["evaluate"]["pesq_nan"])
    log(f"[enhance] PESQ failures: {out['pesq_failures']}")

    # kernels: every shape of a micro-step timed, every other new shape of
    # the phase's runs held untimed
    checks = []
    for i, ((k, shape, cout), cnt) in enumerate(sorted(train_shapes.items(), key=str)):
        r = check_kernel(k, shape, cout, "bfloat16", dev, 300 + i, cycles_per_ms)
        r["launches_per_micro_step"] = cnt
        checks.append(r)
        log(f"[enhance-kernel] {k} {shape}->{cout} bf16 x{cnt}:{plan_text(r['plan'])} "
            f"err {r['max_abs_err']:.3g} (tol {r['tol']:.3g}) ms {r['ms']:.4f} plain {r['plain_ms']:.4f} "
            f"lib {r['library_ms']:.4f} bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")
    for i, ((k, shape, cout), cnt) in enumerate(sorted(shapes.items(), key=str)):
        if (k, shape, cout) in checked or (k, shape, cout) in train_shapes:
            continue
        r = check_kernel(k, shape, cout, "bfloat16", dev, 400 + i, None, timed=False)
        r["launches"] = cnt
        checks.append(r)
        log(f"[enhance-kernel] {k} {shape}->{cout} bf16 x{cnt}:{plan_text(r['plan'])} "
            f"err {r['max_abs_err']:.3g} (tol {r['tol']:.3g}) untimed")
    out["kernel_checks"] = checks
    bad = [r for r in checks if not r["ok"]]
    assert not bad, f"kernel mismatches at enhancement shapes: {bad}"

    out["odd_fir_backward"] = odd = check_odd_fir_backward(dev, 500)
    for r in odd:
        log(f"[enhance] FIR down backward {r['shape']} {r['dtype']} -> {r['grad_shape']} ({r['plan']}): "
            f"err {r['max_abs_err']:.3g} (tol {r['tol']:.3g}), backward launches {r['backward_launches']}")
    out["plain_resampling"] = plain = check_plain_resampling(dev, 501)
    for r in plain:
        log(f"[enhance] plain resampling on the card, {r['case']} {r['shape']} -> {r['out_shape']}: card vs cpu "
            f"{r['max_abs_err']:.3g} (tol {r['tol']:.3g}), kernel launches {r['launches']}")
    assert all(r["ok"] for r in odd + plain), [r for r in odd + plain if not r["ok"]]

    # PriorMixSDE on the nf=32 float32 model, card against CPU with the same
    # draws; and its envelope over 3 s at 16 kHz against float64
    m_gpu, m_cpu = small_pair
    rng = np.random.default_rng(8)
    sde = PriorMixSDE(N=3)
    b, n, N = 1, ENH_FS, 3
    y = torch.from_numpy(rng.standard_normal((b, 1, n)).astype(np.float32))
    prior = {}
    for label, pred, corr in (("reverse_diffusion+ald2", "reverse_diffusion", "ald2"), ("ddim+none", "ddim", "none")):
        draw = {k: torch.from_numpy(rng.standard_normal(lead + (b, 2, n)).astype(np.float32))
                for k, lead in (("prior", ()), ("corrector", (N, 1)), ("predictor", (N,)))}
        ests = {}
        for route, m in (("card", m_gpu), ("cpu", m_cpu)):
            with torch.no_grad():
                ests[route] = pc_sample(sde, m.score_fn, y.to(m.device), pred, corr, N=N, noise=draw)[0].cpu()
        scale = ests["cpu"].abs().max().item()
        prior[label] = dict(scale=scale, card_vs_cpu=(ests["card"] - ests["cpu"]).abs().max().item() / scale)
        log(f"[enhance] nf=32 f32 PriorMixSDE {label} N={N}: card vs cpu {prior[label]['card_vs_cpu']:.3g} "
            f"of scale {scale:.3g}")
    noisy_wav = torch.from_numpy(load_wav(sorted((data / "train" / "noisy").iterdir())[0])[0][None])
    env64 = torch.from_numpy(envelope_float64(noisy_wav.numpy(), sde.avg_len))
    env = {route: sde._std_sigma_mix(noisy_wav.to(route)).double().cpu() for route in ("cuda", "cpu")}
    scale = env64.abs().max().item()
    prior["envelope"] = {f"{r} f32 vs float64": (v - env64).abs().max().item() / scale for r, v in env.items()}
    prior["envelope"]["n_samples"] = noisy_wav.shape[-1]
    log(f"[enhance] PriorMixSDE envelope over {noisy_wav.shape[-1]} samples, f32 cumsum against float64: "
        f"card {prior['envelope']['cuda f32 vs float64']:.3g}, cpu {prior['envelope']['cpu f32 vs float64']:.3g} "
        f"of its max")
    out["prior_mix_check"] = prior
    assert all(prior[k]["card_vs_cpu"] <= 1e-3 for k in ("reverse_diffusion+ald2", "ddim+none")), prior
    assert all(v <= 1e-3 for k, v in prior["envelope"].items() if k != "n_samples"), prior
    out["launches"] = dict(total)
    return out, dict(total)


def percentiles(xs):
    """p50, p95 and max of a list of seconds; None for each where it is
    empty (no request succeeded)."""
    if not xs:
        return dict(p50=None, p95=None, max=None)
    return dict(p50=float(np.percentile(xs, 50)), p95=float(np.percentile(xs, 95)), max=float(max(xs)))


def http_burst(port, bodies):
    """Post every body at once, one connection each, released together by a
    barrier. Returns ([(status, response body, latency s, error)], wall s);
    a connection the server reset or dropped has status None and its error."""
    import http.client
    import threading

    results = [None] * len(bodies)
    barrier = threading.Barrier(len(bodies) + 1)

    def post(i):
        barrier.wait()
        t0 = time.perf_counter()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
            conn.request("POST", "/v1/separate", body=bodies[i], headers={"Content-Type": "audio/wav"})
            resp = conn.getresponse()
            results[i] = (resp.status, resp.read(), time.perf_counter() - t0, None)
            conn.close()
        except (OSError, http.client.HTTPException) as e:
            results[i] = (None, b"", time.perf_counter() - t0, f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    return results, time.perf_counter() - t0


def scrape_metrics(port):
    """GET /metrics -> {series: value}."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/metrics")
    text = conn.getresponse().read().decode()
    conn.close()
    return {key: float(val) for key, val in (line.rsplit(" ", 1) for line in text.splitlines()
                                              if line.strip() and not line.startswith("#"))}


def launches_of(nfe, runs=1):
    return {k: v * nfe * runs for k, v in PER_EVAL.items()}


def serve_entry_phase(dev, card, run_dir, tmp, mix, small_pair, rng, checked):
    """Phase 7: the serving entry points at full width; see the module
    docstring. ``mix`` is the flagship phase's (batch, 1, n) input on the
    card, ``small_pair`` the model phase's nf=32 float32 models (card, CPU),
    ``checked`` the (kernel, shape, cout) keys phases 3 and 6 held against
    the plain versions in bf16. Returns (report, launches over the phase's
    main-path runs)."""
    import torch

    from diffsep_tpu_torch.cli.loading import load_model, read_checkpoint
    from diffsep_tpu_torch.cli.serve import SeparationEngine
    from diffsep_tpu_torch.cli.serve_http import HTTPSeparationServer
    from diffsep_tpu_torch.data.audio_io import load_wav_bytes, save_wav, wav_to_bytes
    from diffsep_tpu_torch.ops import _build
    from diffsep_tpu_torch.ops.plain import plain_kernels
    from diffsep_tpu_torch.sampling import ode_sample, pc_sample
    from diffsep_tpu_torch.streaming import separate_streaming
    from diffsep_tpu_torch.train.losses import normalize_batch

    out, total, shapes = {}, collections.Counter(), collections.Counter()

    def counted(label, want):
        """Read the launches of the run just made, add them and their
        kernel shapes to the phase's totals and hold them against ``want``."""
        torch.cuda.synchronize()
        got = dict(_build.launch_counts)
        total.update(got)
        shapes.update(_build.launch_shapes)
        assert got == want, (label, got, want)
        return got

    # the model: the run dir that the training phase wrote, its EMA weights
    model = load_model(run_dir, device=dev)
    _, raw, ema = read_checkpoint(Path(run_dir) / "checkpoints" / "latest.pt")
    held = model.score_model.state_dict()
    assert all(torch.equal(held[k].cpu(), v) for k, v in ema.items()), "the EMA weights were not loaded"
    assert any(not torch.equal(ema[k], raw[k]) for k in ema), "EMA and raw weights are the same"
    del raw, ema, held
    log(f"[serve7] {Path(run_dir).name}: loaded with its EMA weights through cli.loading.load_model")

    # HTTP: a burst of concurrent clients, more than http.server's default
    # listen backlog, and two requests the engine must refuse
    engine = SeparationEngine(model, batch=HTTP_BATCH, bucket_s=1.0, sampler_kwargs={"N": CHECK_N})
    dispatch, finalize = engine._dispatch_bucket, engine._finalize_bucket
    runs_timed = []  # per sampler run: rows, host s in dispatch, card busy at its return, host s in finalize

    def dispatch_and_probe(mixes):
        t0 = time.perf_counter()
        handle = dispatch(mixes)
        # the card still busy when the dispatch returns: it did not wait
        runs_timed.append(dict(rows=len(mixes), dispatch_s=time.perf_counter() - t0,
                               card_busy=not torch.cuda.current_stream(model.device).query(),
                               bucket_s=-(-max(m.shape[-1] for m in mixes) // engine.bucket) * engine.bucket / FS))
        return handle

    def timed_finalize(handle):
        t0 = time.perf_counter()
        try:
            return finalize(handle)
        finally:
            next(r for r in runs_timed if "finalize_s" not in r)["finalize_s"] = time.perf_counter() - t0

    engine._dispatch_bucket, engine._finalize_bucket = dispatch_and_probe, timed_finalize
    lengths = rng.integers(HTTP_SECONDS[0] * FS, HTTP_SECONDS[1] * FS + 1, size=HTTP_CLIENTS)
    good = [(0.1 * rng.standard_normal((1, int(n)))).astype(np.float32) for n in lengths]
    bad = [(0.1 * rng.standard_normal((2, 3 * FS))).astype(np.float32),  # stereo
           (0.1 * rng.standard_normal((1, 3 * 2 * FS))).astype(np.float32)]  # at 16 kHz
    bodies = [wav_to_bytes(w, FS) for w in good] + [wav_to_bytes(bad[0], FS), wav_to_bytes(bad[1], 2 * FS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    with HTTPSeparationServer(engine, port=0, max_queue=64) as srv:
        results, wall = http_burst(srv.port, bodies)
        metrics = scrape_metrics(srv.port)
    runs = int(metrics["diffsep_batch_fill_count"])
    launches = counted("http", launches_of(CHECK_NFE, runs))
    ok_lat = [lat for status, _, lat, _ in results[:HTTP_CLIENTS] if status == 200]
    resets = [err for *_, err in results if err is not None]
    for w, (status, body, _, err) in zip(good, results):
        assert status == 200, (status, body[:200], err)
        est, sr = load_wav_bytes(body)
        assert sr == FS and est.shape == (2, w.shape[-1]) and np.isfinite(est).all(), (sr, est.shape)
    assert all(status is not None and 400 <= status < 500 for status, *_ in results[HTTP_CLIENTS:]), \
        [r[:2] for r in results[HTTP_CLIENTS:]]
    assert not resets, resets
    assert metrics['diffsep_requests_total{status="ok"}'] == HTTP_CLIENTS, metrics
    assert metrics['diffsep_requests_total{status="error"}'] == len(bad), metrics
    http = dict(
        clients=len(bodies), good=HTTP_CLIENTS, bad=len(bad), lengths_s=[int(n) / FS for n in lengths],
        wall_s=wall, requests_per_s=len(ok_lat) / wall, latency_s=percentiles(ok_lat),
        mean_batch_fill=metrics["diffsep_batch_fill_sum"] / max(runs, 1), program_runs=runs,
        connection_resets=len(resets), statuses=[r[0] for r in results], launches=launches,
        runs=runs_timed,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, metrics=metrics)
    out["http"] = http
    lat = {k: "n/a" if v is None else f"{v:.3f}" for k, v in http["latency_s"].items()}
    log(f"[serve7] http: {HTTP_CLIENTS} requests of {HTTP_SECONDS[0]}-{HTTP_SECONDS[1]} s + {len(bad)} bad, "
        f"batch {HTTP_BATCH}, reverse_diffusion+ald2 N={CHECK_N}: {http['requests_per_s']:.3f} requests/s, "
        f"latency p50 {lat['p50']} p95 {lat['p95']} max {lat['max']} s, mean batch fill "
        f"{http['mean_batch_fill']:.2f}, {runs} program runs, peak {http['peak_mem_gib']:.2f} GiB, "
        f"{len(resets)} connection resets ({card})")
    log(f"[serve7] http: statuses {http['statuses']}; launches {launches}")
    for r in runs_timed:
        log(f"[serve7] http run: {r['rows']} rows of the {r['bucket_s']:.0f} s bucket, host {r['dispatch_s']:.3f} s "
            f"in the dispatch (card {'still busy' if r['card_busy'] else 'idle'} at its return), "
            f"{r.get('finalize_s', float('nan')):.3f} s in the finalize")
    del engine

    # stdin: the module run as `python -m` runs it, in a process of its own
    # that prints its launch counts and kernel shapes at exit; 4 paths in
    # one write
    stdin_dir, stdin_out = Path(tmp) / "stdin_in", Path(tmp) / "stdin_out"
    paths = []
    for i, n in enumerate(rng.integers(2 * FS + 1, 3 * FS + 1, size=4)):  # one 3 s bucket
        paths.append(stdin_dir / f"req{i}.wav")
        save_wav(paths[-1], (0.1 * rng.standard_normal((1, int(n)))).astype(np.float32), FS)
    code = ("import atexit, json, runpy, sys; from diffsep_tpu_torch.ops import _build; "
            "atexit.register(lambda: print('LAUNCHES', json.dumps(dict(_build.launch_counts)), 'SHAPES', "
            "json.dumps([[*key, n] for key, n in _build.launch_shapes.items()]), file=sys.stderr)); "
            "runpy.run_module('diffsep_tpu_torch.cli.serve', run_name='__main__', alter_sys=True)")
    argv = [str(stdin_out), "--model", str(run_dir), "-N", str(STDIN_N), "--predictor", "ddim",
            "--corrector", "none"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, *argv], input="".join(f"{p}\n" for p in paths),
                          capture_output=True, text=True, timeout=600, cwd=Path(__file__).resolve().parent)
    secs = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-3000:]
    done = [line for line in proc.stdout.splitlines() if line.startswith("DONE ")]
    wavs = sorted(stdin_out.glob("s*/*.wav"))
    got, child_shapes = proc.stderr.rsplit("LAUNCHES", 1)[1].splitlines()[0].split(" SHAPES ")
    got = json.loads(got)
    total.update(got)
    shapes.update({(k, tuple(shape), cout): n for k, shape, cout, n in json.loads(child_shapes)})
    assert len(done) == len(paths) and len(wavs) == 2 * len(paths), (proc.stdout, wavs)
    assert got == launches_of(STDIN_N), got
    out["stdin"] = dict(seconds=secs, done=done, wavs=len(wavs), launches=got)
    log(f"[serve7] stdin: python -m diffsep_tpu_torch.cli.serve OUT --model RUN_DIR {' '.join(argv[3:])}: "
        f"{len(done)} DONE, {len(wavs)} wavs, one micro-batch, {secs:.1f} s with start-up; launches {got}")

    # streaming: a 20 s mixture in 5 s chunks, one batch of 8 rows
    mix20 = (0.1 * rng.standard_normal((1, STREAM_SECONDS * FS))).astype(np.float32)
    _build.reset_counts()
    t0 = time.perf_counter()
    est = separate_streaming(model, mix20, chunk_s=5.0, overlap_s=0.5, batch=8,
                             generator=torch.Generator(device=dev).manual_seed(0),
                             predictor_name="ddim", corrector_name="none", N=STDIN_N)
    secs = time.perf_counter() - t0
    got = counted("streaming", launches_of(STDIN_N))
    assert est.shape == (2, STREAM_SECONDS * FS) and np.isfinite(est).all(), est.shape
    out["streaming"] = dict(seconds=secs, shape=list(est.shape), launches=got)
    log(f"[serve7] streaming: {STREAM_SECONDS} s in 5 s chunks, overlap 0.5 s, batch 8, ddim N={STDIN_N}: "
        f"{est.shape}, finite, {secs:.2f} s; launches {got}")

    # every new sampler at full width, and the ODE sampler
    (mix_n, _), _, _ = normalize_batch(mix)
    samplers = {}
    for label, pred, corr, settings in SAMPLER_CASES:
        _build.reset_counts()
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(0)
        if pred == "ode":
            with torch.no_grad():
                est, nfe = ode_sample(model.sde, model.score_fn, mix_n, N=SAMPLER_N, eps=model.t_eps, generator=gen)
        else:
            est, nfe = model.separate(mix, generator=gen, predictor_name=pred, corrector_name=corr, N=SAMPLER_N,
                                      **settings)
        got = counted(label, launches_of(nfe))
        assert est.shape == mix.shape[:1] + (2, mix.shape[-1]) and torch.isfinite(est).all(), label
        samplers[label] = dict(nfe=nfe, seconds=time.perf_counter() - t0, launches=got)
        log(f"[serve7] {label} N={SAMPLER_N}: {nfe} evaluations, {tuple(est.shape)} finite, "
            f"{samplers[label]['seconds']:.2f} s")
    out["samplers"] = samplers

    # every kernel shape of the runs above that phases 3 and 6 did not hold
    # against its plain version (the HTTP buckets and stdin at batch 4,
    # streaming at batch 8), bf16, untimed
    checks = []
    for i, ((k, shape, cout), cnt) in enumerate(sorted(shapes.items(), key=str)):
        if (k, shape, cout) in checked:
            continue
        r = check_kernel(k, shape, cout, "bfloat16", dev, 200 + i, None, timed=False)
        r["launches"] = cnt
        checks.append(r)
        log(f"[serve7-kernel] {k} {shape}->{cout} bf16 x{cnt}:{plan_text(r['plan'])} "
            f"err {r['max_abs_err']:.3g} (tol {r['tol']:.3g})")
    out["kernel_checks"] = checks
    log(f"[serve7] {len(shapes)} kernel shapes in the runs above, {len(checks)} of them new, each held "
        f"against its plain version")
    bad = [r for r in checks if not r["ok"]]
    assert not bad, f"kernel mismatches at serving shapes: {bad}"

    # nf=32 float32: each new sampler on the card and on the CPU, same draws
    m_gpu, m_cpu = small_pair
    b, n, N = 1, FS, 3
    y = torch.from_numpy(rng.standard_normal((b, 1, n)).astype(np.float32))
    small = {}
    for label, pred, corr, settings in SAMPLER_CASES:
        draw = {k: torch.from_numpy(rng.standard_normal(lead + (b, 2, n)).astype(np.float32))
                for k, lead in (("prior", ()), ("corrector", (N, 1)), ("predictor", (N,)))}
        ests = {}
        for route, m in (("card", m_gpu), ("plain on the card", m_gpu), ("cpu", m_cpu)):
            with plain_kernels() if route == "plain on the card" else contextlib.nullcontext(), torch.no_grad():
                if pred == "ode":
                    est, _ = ode_sample(m.sde, m.score_fn, y.to(m.device), N=N, prior=draw["prior"])
                else:
                    est, _ = pc_sample(m.sde, m.score_fn, y.to(m.device), pred, corr, N=N, noise=draw, **settings)
            ests[route] = est.cpu()
        scale = ests["cpu"].abs().max().item()
        small[label] = dict(scale=scale, **{f"{r} vs cpu": (ests[r] - ests["cpu"]).abs().max().item() / scale
                                            for r in ("card", "plain on the card")})
        log(f"[serve7] nf=32 f32 {label} N={N}: card vs cpu {small[label]['card vs cpu']:.3g}, plain on the "
            f"card vs cpu {small[label]['plain on the card vs cpu']:.3g} of scale {scale:.3g}")
    out["small_f32_sampler_check"] = small
    bad = {k: v for k, v in small.items() if not v["card vs cpu"] <= 1e-3}
    assert not bad, bad
    out["launches"] = dict(total)
    return out, dict(total)


def counting_distill_step(per_step):
    """A stand-in for ``train.distill.make_distill_step`` whose step appends
    its host start, launches (all and backward), kernel shapes and the peak
    memory after it to ``per_step``."""
    import torch

    from diffsep_tpu_torch.ops import _build
    from diffsep_tpu_torch.train import distill

    make_distill_step = distill.make_distill_step

    def counted(*args, **kwargs):
        step = make_distill_step(*args, **kwargs)

        def run(state, teacher, mix, target, draws=None):
            before = [collections.Counter(c) for c in
                      (_build.launch_counts, _build.backward_counts, _build.launch_shapes)]
            t0 = time.perf_counter()
            metrics = step(state, teacher, mix, target, draws)
            after = (_build.launch_counts, _build.backward_counts, _build.launch_shapes)
            launches, backward, shapes = (collections.Counter(a) - b for a, b in zip(after, before))
            per_step.append(dict(start=t0, launches=dict(launches), backward=dict(backward), shapes=shapes,
                                 batch=list(mix.shape), loss=metrics["distill/loss"],
                                 peak_gib=torch.cuda.max_memory_allocated() / 2**30))
            return metrics

        return run

    return counted


def synced_distill_stage(ends):
    """A stand-in for ``train.distill.distill_stage`` that ends each stage
    with ``torch.cuda.synchronize()`` and appends the host clock then to
    ``ends``."""
    import torch

    from diffsep_tpu_torch.train import distill

    distill_stage = distill.distill_stage

    def run(*args, **kwargs):
        state = distill_stage(*args, **kwargs)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        return state

    return run


def distill_phase(dev, card, run_dir, tmp, small_pair, checked):
    """Phase 9: distillation and the export artifact through their entry
    points, on the run dir of phase 6; see the module docstring. Returns
    (report, launches over the phase's main-path runs)."""
    import os

    import torch

    from diffsep_tpu_torch.cli import distill as distill_cli
    from diffsep_tpu_torch.cli import export_model as export_cli
    from diffsep_tpu_torch.cli import separate as sep_cli
    from diffsep_tpu_torch.cli.loading import load_model
    from diffsep_tpu_torch.data.audio_io import load_wav
    from diffsep_tpu_torch.export import load_separator
    from diffsep_tpu_torch.ops import _build
    from diffsep_tpu_torch.ops.plain import plain_kernels
    from diffsep_tpu_torch.train import distill
    from diffsep_tpu_torch.train.losses import Draws

    out, total, shapes = {}, collections.Counter(), collections.Counter()

    def counted(label, want):
        torch.cuda.synchronize()
        got = dict(_build.launch_counts)
        total.update(got)
        shapes.update(_build.launch_shapes)
        assert got == want, (label, got, want)
        return got

    # distillation: cli.distill on the run dir's EMA weights and its data
    dist_root = Path(tmp) / "distilled"
    argv = [str(run_dir), "--stages", ",".join(map(str, DISTILL_STAGES)), "--steps", str(DISTILL_STEPS),
            "--teacher-substeps", "2", "--schedule", "log", "--out", str(dist_root), "--log-every", "1"]
    log(f"[distill] python -m diffsep_tpu_torch.cli.distill {' '.join(argv)}")
    per_step, ends = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    t0 = time.perf_counter()
    with mock.patch.object(distill, "make_distill_step", counting_distill_step(per_step)), \
            mock.patch.object(distill, "distill_stage", synced_distill_stage(ends)):
        distill_cli.main(argv)
    run_s = time.perf_counter() - t0
    want_step = {k: 3 * v for k, v in PER_EVAL.items()}  # 2 teacher substeps and the student
    want_bwd = {k: v[1] for k, v in TRAIN_PER_STEP.items() if v[1]}
    for k, v in want_bwd.items():
        want_step[k] += v
    n_steps = len(DISTILL_STAGES) * DISTILL_STEPS
    counted("cli.distill", {k: n_steps * v for k, v in want_step.items()})
    assert len(per_step) == n_steps and len(ends) == len(DISTILL_STAGES), (len(per_step), len(ends))
    for st in per_step:
        assert st["launches"] == want_step and st["backward"] == want_bwd, (st["launches"], st["backward"])
        assert st["batch"] == [TRAIN_BATCH, 1, SERVE_SECONDS * FS], st["batch"]
    losses = [float(st["loss"]) for st in per_step]
    assert all(np.isfinite(losses)), losses
    stages = []
    for si, n in enumerate(DISTILL_STAGES):
        steps = per_step[si * DISTILL_STEPS:(si + 1) * DISTILL_STEPS]
        ms = (ends[si] - steps[1]["start"]) * 1e3 / (DISTILL_STEPS - 1)
        stages.append(dict(n=n, ms_per_step=ms, samples_per_s=TRAIN_BATCH * 1e3 / ms,
                           losses=losses[si * DISTILL_STEPS:(si + 1) * DISTILL_STEPS]))
        log(f"[distill] N={n}: {DISTILL_STEPS} steps of batch {TRAIN_BATCH} x {SERVE_SECONDS} s, timed "
            f"{DISTILL_STEPS - 1} after the first: {ms:.2f} ms per step, {TRAIN_BATCH * 1e3 / ms:.3f} samples/s "
            f"({card}); losses {[f'{v:.6g}' for v in stages[-1]['losses']]}")
    peak = max(st["peak_gib"] for st in per_step)
    log(f"[distill] {n_steps} steps in {run_s:.1f} s with loading and 2 checkpoints; peak {peak:.2f} GiB; "
        f"launches per step {per_step[-1]['launches']}, of them backward {per_step[-1]['backward']}")
    out["distill"] = dict(run_s=run_s, stages=stages, peak_gib=peak, launches_per_step=per_step[-1]["launches"],
                          backward_per_step=per_step[-1]["backward"])
    step_shapes = per_step[-1]["shapes"]

    # one on-policy step at N=2: the student's own trajectory, N - 1 = 1
    # more evaluation without autograd
    student_dir = dist_root / f"N{DISTILL_STAGES[-1]}"
    model = load_model(student_dir, device=dev)
    teacher = distill.frozen_copy(model.score_model)
    state = model.init_state()
    cfg = distill.DistillConfig(n_student=DISTILL_STAGES[-1], schedule="log", on_policy_frac=1.0,
                                source_order=model.loss_cfg.train_source_order)
    step = distill.make_distill_step(model.score_model, model.sde, model.optim_cfg, 0, cfg)
    g = torch.Generator(device=dev).manual_seed(9)
    tgt = 0.1 * torch.randn((TRAIN_BATCH, 2, SERVE_SECONDS * FS), generator=g, device=dev)
    _build.reset_counts()
    metrics = step(state, teacher, tgt.sum(dim=1, keepdim=True), tgt)
    evals = 3 + DISTILL_STAGES[-1] - 1
    onpol = counted("on-policy step", {k: evals * v + want_bwd.get(k, 0) for k, v in PER_EVAL.items()})
    assert np.isfinite(metrics["distill/loss"].item())
    out["on_policy_step"] = dict(evaluations=evals, launches=onpol, loss=metrics["distill/loss"].item())
    log(f"[distill] on-policy step, N={DISTILL_STAGES[-1]}: {evals} forward evaluations (2 teacher, the student, "
        f"{DISTILL_STAGES[-1] - 1} of its trajectory), launches {onpol}, loss {out['on_policy_step']['loss']:.6g}")
    del teacher, state, step

    # the student through cli.separate, without sampler flags
    n_student = DISTILL_STAGES[-1]
    files = sorted((Path(tmp) / "wsj0_mix" / "2speakers/wav8k/max/cv/mix").iterdir())[:2]
    sep_in = Path(tmp) / "student_in"
    sep_in.mkdir()
    for f in files:
        os.symlink(f, sep_in / f.name)
    _build.reset_counts()
    t0 = time.perf_counter()
    sep_cli.main([str(sep_in), str(Path(tmp) / "student_out"), "--model", str(student_dir)])
    secs = time.perf_counter() - t0
    got = counted("cli.separate student", launches_of(n_student, len(files)))
    for f in files:
        for src in range(2):
            est, fs = load_wav(Path(tmp) / "student_out" / f"s{src}" / f.name)
            assert fs == FS and est.shape == load_wav(f)[0].shape and np.isfinite(est).all(), f.name
    out["student_separate"] = dict(files=len(files), seconds=secs, launches=got)
    log(f"[distill] cli.separate IN OUT --model {student_dir.name} (ddim, none, N={n_student}, log grid from its "
        f"config): {len(files)} files in {secs:.1f} s with loading; launches {got}")

    # the export artifact of the student, and the artifact against the live model
    art = Path(tmp) / "student.dst"
    t0 = time.perf_counter()
    export_cli.main([str(student_dir), "-o", str(art), "--batch", str(SERVE_BATCH), "--len-s", str(SERVE_SECONDS)])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sep = load_separator(art)
    load_s = time.perf_counter() - t0
    assert sep.meta["sampler"]["predictor_name"] == "ddim" and sep.meta["sampler"]["N"] == n_student
    rng = np.random.default_rng(12)
    n = SERVE_SECONDS * FS
    n_true = 3 * n // 5  # a 3 s request in the 5 s row
    mix = (0.1 * rng.standard_normal((SERVE_BATCH, 1, n))).astype(np.float32)
    mix[1, :, n_true:] = 0.0
    n_valid = np.array([n, n_true])
    calls = []
    for i in range(ART_CALLS):
        torch.cuda.synchronize()
        _build.reset_counts()
        t0 = time.perf_counter()
        est = sep.call(21, mix, n_valid)
        torch.cuda.synchronize()
        calls.append(time.perf_counter() - t0)
        got = counted("artifact call", launches_of(n_student))
    want, nfe = model.separate_masked(mix, n_valid, generator=torch.Generator(device=dev).manual_seed(21))
    assert nfe == n_student
    scale = want.abs().max().item()
    diff = (est - want).abs().max().item()
    assert est.shape == (SERVE_BATCH, 2, n) and torch.isfinite(est).all() and diff <= 1e-5 * scale, (diff, scale)
    assert (est[1, :, n_true:] == 0).all()
    out["artifact"] = dict(export_s=export_s, load_s=load_s, bytes=art.stat().st_size, call_s=calls,
                           utt_per_s=[SERVE_BATCH / s for s in calls], launches_per_call=got,
                           max_abs_vs_live=diff, scale=scale, bit_exact=diff == 0.0)
    log(f"[artifact] cli.export_model {student_dir.name} --batch {SERVE_BATCH} --len-s {SERVE_SECONDS}: "
        f"{export_s:.1f} s, {art.stat().st_size / 1e6:.1f} MB, loaded in {load_s:.1f} s")
    log(f"[artifact] call at {SERVE_BATCH} x {SERVE_SECONDS} s, N={n_student}: "
        f"{', '.join(f'{SERVE_BATCH / s:.3f}' for s in calls)} utt/s ({card}); launches per call {got}; "
        f"against the live separate_masked on the same seed: {diff:.3g} of scale {scale:.3g}"
        f"{' (bit for bit)' if diff == 0.0 else ''}")
    del model

    # the artifact through cli.separate and cli.serve's stdin loop
    _build.reset_counts()
    t0 = time.perf_counter()
    sep_cli.main([str(sep_in), str(Path(tmp) / "artifact_out"), "--model", str(art)])
    secs = time.perf_counter() - t0
    got = counted("cli.separate artifact", launches_of(n_student, -(-len(files) // SERVE_BATCH)))
    for f in files:
        est_f, fs = load_wav(Path(tmp) / "artifact_out" / "s0" / f.name)
        assert fs == FS and est_f.shape == load_wav(f)[0].shape and np.isfinite(est_f).all(), f.name
    out["artifact_separate"] = dict(files=len(files), seconds=secs, launches=got)
    log(f"[artifact] cli.separate IN OUT --model student.dst: {len(files)} files in {secs:.1f} s with loading; "
        f"launches {got}")
    paths = sorted((Path(tmp) / "wsj0_mix" / "2speakers/wav8k/max/tr/mix").iterdir())[:4]
    code = ("import atexit, json, runpy, sys; from diffsep_tpu_torch.ops import _build; "
            "atexit.register(lambda: print('LAUNCHES', json.dumps(dict(_build.launch_counts)), 'SHAPES', "
            "json.dumps([[*key, n] for key, n in _build.launch_shapes.items()]), file=sys.stderr)); "
            "runpy.run_module('diffsep_tpu_torch.cli.serve', run_name='__main__', alter_sys=True)")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, str(Path(tmp) / "serve_art"), "--model", str(art)],
                          input="".join(f"{p}\n" for p in paths), capture_output=True, text=True, timeout=600,
                          cwd=Path(__file__).resolve().parent)
    secs = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-3000:]
    done = [line for line in proc.stdout.splitlines() if line.startswith("DONE ")]
    got, child_shapes = proc.stderr.rsplit("LAUNCHES", 1)[1].splitlines()[0].split(" SHAPES ")
    got = json.loads(got)
    total.update(got)
    shapes.update({(k, tuple(shape), cout): c for k, shape, cout, c in json.loads(child_shapes)})
    runs = -(-len(paths) // SERVE_BATCH)
    assert len(done) == len(paths) and got == launches_of(n_student, runs), (proc.stdout, got)
    out["artifact_serve_stdin"] = dict(requests=len(paths), seconds=secs, launches=got)
    log(f"[artifact] stdin: python -m diffsep_tpu_torch.cli.serve OUT --model student.dst: {len(done)} DONE in "
        f"{runs} artifact calls, {secs:.1f} s with start-up; launches {got}")

    # every kernel shape of these runs that earlier phases did not hold
    # against its plain version, bf16, untimed (the distill step's are the
    # training micro-step's)
    checks = []
    for i, ((k, shape, cout), cnt) in enumerate(sorted((shapes + step_shapes).items(), key=str)):
        if (k, shape, cout) in checked:
            continue
        r = check_kernel(k, shape, cout, "bfloat16", dev, 600 + i, None, timed=False)
        r["launches"] = cnt
        checks.append(r)
        log(f"[distill-kernel] {k} {shape}->{cout} bf16 x{cnt}:{plan_text(r['plan'])} "
            f"err {r['max_abs_err']:.3g} (tol {r['tol']:.3g}) untimed")
    out["kernel_checks"] = checks
    log(f"[distill] {len(set(shapes) | set(step_shapes))} kernel shapes in the runs above, {len(checks)} of them "
        f"new, each held against its plain version")
    assert all(r["ok"] for r in checks), [r for r in checks if not r["ok"]]

    # nf=32 float32: distill_loss and the student's gradients, kernels vs
    # plain on the card and card vs CPU, on the same draws (on-policy and
    # prior-at-T inputs included)
    m_gpu, m_cpu = small_pair
    b, n = 4, FS
    d_rng = np.random.default_rng(13)
    tgt = torch.from_numpy((0.3 * d_rng.standard_normal((b, 2, n))).astype(np.float32))
    draws = {"i": np.array([0, 3, 1, 2]), "z": d_rng.standard_normal((b, 2, n)).astype(np.float32),
             "use_prior": np.array([0.2, 0.9, 0.1, 0.3], np.float32),
             "onpol_prior": d_rng.standard_normal((b, 2, n)).astype(np.float32),
             "use_onpol": np.array([0.1, 0.7, 0.9, 0.2], np.float32)}
    cfg = distill.DistillConfig(n_student=4, on_policy_frac=0.5)
    res, counts = {}, {}
    for route, m in (("kernels", m_gpu), ("plain", m_gpu), ("cpu", m_cpu)):
        sm = m.score_model
        teacher = distill.frozen_copy(sm)
        with torch.no_grad():
            for p in teacher.parameters():
                p.mul_(0.99)
        with plain_kernels() if route == "plain" else contextlib.nullcontext():
            sm.zero_grad(set_to_none=True)
            _build.reset_counts()
            loss = distill.distill_loss(Draws(None, draws), m.sde, sm, teacher, tgt.sum(dim=1, keepdim=True).to(m.device),
                                        tgt.to(m.device), cfg)
            loss.backward()
            if m.device.type == "cuda":
                torch.cuda.synchronize()
            counts[route] = (dict(_build.launch_counts), dict(_build.backward_counts))
        res[route] = loss.item(), {name: p.grad.float().cpu() for name, p in sm.named_parameters()
                                   if p.grad is not None}
        sm.zero_grad(set_to_none=True)

    def grad_err(a, b):
        ga, gb = res[a][1], res[b][1]
        norm = torch.sqrt(sum((v.double() ** 2).sum() for v in gb.values())).item()
        return max((ga[k] - gb[k]).abs().max().item() for k in gb) / norm

    pairs = {"kernels vs plain on the card": ("kernels", "plain"), "card vs cpu": ("kernels", "cpu")}
    grad_check = {name: grad_err(a, b) for name, (a, b) in pairs.items()}
    loss_rel = {name: abs(res[a][0] - res[b][0]) / abs(res[b][0]) for name, (a, b) in pairs.items()}
    out["small_f32_distill_grad_check"] = dict(grad_rel_err=grad_check, loss_rel_err=loss_rel, tol=GRAD_TOL,
                                               launches=counts["kernels"], losses={k: v[0] for k, v in res.items()})
    for name, v in grad_check.items():
        log(f"[distill] nf=32 f32 distill_loss gradients, {name}: {v:.3g} of the gradient norm "
            f"(loss {loss_rel[name]:.3g} relative)")
    for name, tol in GRAD_TOL.items():
        assert grad_check[name] <= tol and loss_rel[name] <= tol, (name, grad_check[name], loss_rel[name])
    assert counts["kernels"][0]["conv3x3"] > 0 and not counts["plain"][0], counts
    out["launches"] = dict(total)
    return out, dict(total)


# --- phase 10: data parallelism and multi-device evaluation ----------------
def small_ddp_updates(dev, rank=0, world=1):
    """The nf=32 float32 model's update through the train step (two
    accumulated micro-steps, init hack 5) and the distillation step (one
    step), on this rank's rows of a batch of 4 x 1 s and of its draws,
    through DDP where ``world`` > 1. Returns each step's losses and gradient
    norms, and Adam's moments after the update, on the host."""
    import torch

    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.parallel import mesh
    from diffsep_tpu_torch.train import distill

    rng = np.random.default_rng(21)
    b, n = 4, FS
    rows = slice(rank * b // world, (rank + 1) * b // world)
    cfg = {"model": {"init_hack": 5, "init_hack_p": 0.5, "optimizer": {"lr": 1e-3}, **DDP_SMALL},
           "trainer": {"accumulate_grad_batches": 2}}

    def batch():
        tgt = rng.standard_normal((b, 2, n)).astype(np.float32)
        return torch.from_numpy(tgt.sum(axis=1, keepdims=True)), torch.from_numpy(tgt)

    def take(x):
        return torch.as_tensor(x)[rows].to(dev)

    def randomized(config, seed):
        cpu = DiffSepModel(config, device="cpu", seed=1)
        randomize_(cpu.score_model, seed=seed)
        model = DiffSepModel(config, device=dev, seed=1)
        model.score_model.load_state_dict(cpu.score_model.state_dict())
        return model

    out = {}
    model = randomized(cfg, 3)
    state = model.init_state()
    step = model.make_train_step(seed=0, forward=mesh.wrap_ddp(model.score_model, dev))
    metrics = []
    for _ in range(2):
        mix, tgt = batch()
        draws = {"mask": rng.uniform(size=b).astype(np.float32), "z0": rng.standard_normal((b, 2, n), np.float32),
                 "z": rng.standard_normal((b, 2, n), np.float32),
                 "shuffle": rng.uniform(size=(b, 2)).astype(np.float32),
                 "time": rng.uniform(size=b).astype(np.float32)}
        metrics.append(step(state, take(mix), take(tgt), draws={k: take(v) for k, v in draws.items()}))
    out["train"] = dict(losses=[float(m["train/score_loss"]) for m in metrics],
                        grad_norms=[float(m["grad/norm"]) for m in metrics],
                        mu=[t.cpu() for t in state.optimizer.mu], nu=[t.cpu() for t in state.optimizer.nu])

    model = randomized(cfg["model"], 4)  # no accumulation: one step updates
    teacher = distill.frozen_copy(model.score_model)
    with torch.no_grad():
        for p in model.score_model.parameters():
            p.add_(0.01)
    state = model.init_state()
    dstep = distill.make_distill_step(model.score_model, model.sde, model.optim_cfg, 0,
                                      distill.DistillConfig(n_student=4),
                                      forward=mesh.wrap_ddp(model.score_model, dev))
    mix, tgt = batch()
    draws = {"i": np.array([0, 3, 1, 2]), "z": rng.standard_normal((b, 2, n), np.float32),
             "use_prior": np.array([0.2, 0.9, 0.1, 0.3], np.float32)}
    m = dstep(state, teacher, take(mix), take(tgt), draws={k: take(v) for k, v in draws.items()})
    out["distill"] = dict(losses=[float(m["distill/loss"])], grad_norms=[float(m["grad/norm"])],
                          mu=[t.cpu() for t in state.optimizer.mu], nu=[t.cpu() for t in state.optimizer.nu])
    return out


def ddp_worker(rank, world, init_method, backend, card_index, overrides, out_dir):
    """One rank of phase 10's data-parallel run (a process of its own): the
    recipe's fit through ``cli.train.train`` with its launches per
    micro-step and a digest after every optimizer step, then the nf=32
    updates through DDP; writes rank<r>.json and small_rank<r>.pt."""
    import torch
    import torch.distributed as dist

    from diffsep_tpu_torch.cli import train as train_cli
    from diffsep_tpu_torch.config import compose
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.ops import _build
    from diffsep_tpu_torch.train.checkpoints import CheckpointManager
    from diffsep_tpu_torch.utils.distributed import initialize_distributed

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # card_index None: the CPU, where there is no card
    dev = torch.device("cpu") if card_index is None else torch.device("cuda", card_index)
    initialize_distributed(backend=backend, device_type=dev.type, rank=rank, world_size=world,
                           init_method=init_method, device_index=card_index)
    per_step, snapshots, saves = [], [], []
    save = CheckpointManager.save

    def counted_save(self, step, *args, **kwargs):
        saves.append(step)
        return save(self, step, *args, **kwargs)

    try:
        _build.reset_counts()
        with mock.patch.object(DiffSepModel, "make_train_step", counting_train_step(per_step, snapshots)), \
                mock.patch.object(CheckpointManager, "save", counted_save):
            state = train_cli.train(compose(overrides), overrides, str(dev))
        digests = [params_digest(t) for t in snapshots]
        del snapshots[:]
        report = dict(rank=rank, step=state.step, digests=digests, saves=saves, launches=dict(_build.launch_counts),
                      shapes=[[k, list(shape), cout] for k, shape, cout in _build.launch_shapes],
                      per_step=[dict(launches=s["launches"], backward=s["backward"], batch=s["batch"])
                                for s in per_step],
                      peak_gib=max(s["peak_gib"] for s in per_step))
        torch.save(small_ddp_updates(dev, rank, world), Path(out_dir) / f"small_rank{rank}.pt")
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def run_ranks(target, args_of, world, timeout_s):
    """``world`` spawned processes of ``target(*args_of(rank))``; raises as
    soon as one fails or the time is up (the others are terminated)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(r)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            codes = [p.exitcode for p in procs]
            assert not any(c not in (None, 0) for c in codes), f"rank exit codes {codes}"
            if all(c == 0 for c in codes):
                return
            assert time.monotonic() < deadline, f"ranks still running after {timeout_s} s: {codes}"
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=30)


def rel_err(got, want):
    """max |got - want| over a list of tensors, over their global norm."""
    import torch

    norm = torch.sqrt(sum((w.double() ** 2).sum() for w in want)).item()
    return max((g - w).abs().max().item() for g, w in zip(got, want)) / norm


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ddp_phase(dev, card, tmp, run_dir, data, checked):
    """Phase 10: data parallelism and multi-device evaluation; see the
    module docstring. ``run_dir`` and ``data`` are phase 6's run dir and
    folder, ``checked`` the (kernel, shape, cout) keys earlier phases held
    against the plain versions in bf16. Returns (report, launches over the
    phase's main-path runs)."""
    import torch

    from diffsep_tpu_torch.cli import evaluate_mp
    from diffsep_tpu_torch.cli import train as train_cli
    from diffsep_tpu_torch.data.synthetic import write_wsj0_mix
    from diffsep_tpu_torch.ops import _build

    out, total, shapes = {}, collections.Counter(), set()
    t_phase = time.perf_counter()
    cards = [0, 1] if torch.cuda.device_count() >= DDP_RANKS else [0] * DDP_RANKS
    backend = "nccl" if len(set(cards)) == DDP_RANKS else "gloo"
    out["backend"], out["cards"] = backend, cards
    log(f"[ddp] {DDP_RANKS} ranks on cards {cards}, process group backend {backend} ({card})")

    # 1. the recipe's fit on 2 ranks, each spawned here
    data10 = write_wsj0_mix(Path(tmp) / "wsj0_mix_ddp", {"train": 2 * DDP_RANKS * DDP_BATCH, "val": 5,
                                                          "test": DDP_TEST}, seconds=SERVE_SECONDS, fs=FS, seed=10)
    overrides = ["experiment=icassp-separation", f"path.datasets.wsj0_mix={data10}",
                 f"path.exp_root={tmp}/exp_ddp", f"trainer.max_steps={DDP_STEPS}",
                 f"trainer.check_val_every_n_epoch={DDP_STEPS // 2}",
                 f"datamodule.train.dl_opts.batch_size={DDP_BATCH}", "model.valid_max_sep_batches=1", "test=true",
                 f"model.sampler.N={CHECK_N}"]
    log(f"[ddp] fit on {DDP_RANKS} ranks: cli.train.train {' '.join(overrides)}")
    ddp_dir = Path(tmp) / "ddp_reports"
    ddp_dir.mkdir()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    run_ranks(ddp_worker, lambda r: (r, DDP_RANKS, init_method, backend, cards[r], overrides, str(ddp_dir)),
              DDP_RANKS, 600)
    out["ranks_s"] = time.perf_counter() - t0
    reports = [json.loads((ddp_dir / f"rank{r}.json").read_text()) for r in range(DDP_RANKS)]
    run10 = next(Path(tmp, "exp_ddp").glob("*/*/train_log.jsonl")).parent
    speed, rows = train_speed(run10, TRAIN_WARMUP, DDP_STEPS - TRAIN_WARMUP, DDP_RANKS * DDP_BATCH)
    index = json.loads((run10 / "checkpoints" / "index.json").read_text())
    parts = [json.loads((run10 / "test_results" / f"part{r}" / "test.json").read_text()) for r in range(DDP_RANKS)]
    merged = json.loads((run10 / "test_results" / "test.json").read_text())
    for r in reports:
        total.update(r["launches"])
        shapes |= {(k, tuple(shape), cout) for k, shape, cout in r["shapes"]}
    want = {k: sum(v) for k, v in TRAIN_PER_STEP.items()}
    want_bwd = {k: v[1] for k, v in TRAIN_PER_STEP.items() if v[1]}
    out["fit"] = dict(**speed, peak_gib_per_rank=[r["peak_gib"] for r in reports], validation=index,
                      losses=[r["train/score_loss"] for r in rows], saves=[r["saves"] for r in reports],
                      per_rank_micro_step=reports[0]["per_step"][-1], launches=[r["launches"] for r in reports])
    log(f"[ddp] {DDP_STEPS} micro-steps of {DDP_RANKS} x {reports[0]['per_step'][0]['batch']} with validation, "
        f"checkpoint and test=true on {DDP_TEST} files in {out['ranks_s']:.1f} s with start-up; timed "
        f"{DDP_STEPS - TRAIN_WARMUP} after {TRAIN_WARMUP}: {speed['ms_per_micro_step']:.2f} ms per micro-step, "
        f"{speed['samples_per_s']:.3f} global samples/s, peak per rank "
        f"{', '.join('%.2f' % r['peak_gib'] for r in reports)} GiB ({backend}, {card})")
    log(f"[ddp] losses {out['fit']['losses']}; validation {index}; checkpoints saved per rank "
        f"{out['fit']['saves']}; launches per micro-step per rank {reports[0]['per_step'][-1]['launches']}, "
        f"of them backward {reports[0]['per_step'][-1]['backward']}")
    assert all(r["step"] == DDP_STEPS and len(r["per_step"]) == DDP_STEPS for r in reports), reports
    assert all(s["launches"] == want and s["backward"] == want_bwd and s["batch"][0] == DDP_BATCH
               for r in reports for s in r["per_step"]), [r["per_step"] for r in reports]
    assert all(r["digests"] == reports[0]["digests"] for r in reports) and len(reports[0]["digests"]) == DDP_STEPS // 2
    assert [r["saves"] for r in reports] == [[DDP_STEPS]] + [[]] * (DDP_RANKS - 1), out["fit"]["saves"]
    assert list(index) == [str(DDP_STEPS)] and np.isfinite(index[str(DDP_STEPS)]["val/si_sdr"]), index
    assert all(np.isfinite(out["fit"]["losses"])), out["fit"]["losses"]
    assert [len(p) for p in parts] == [DDP_TEST // DDP_RANKS] * DDP_RANKS
    assert [m["batch_idx"] for m in merged] == list(range(DDP_TEST))
    assert [m["len_s"] for m in merged] == [m["len_s"] for p in parts for m in p]
    assert all(np.isfinite(np.mean(m["si_sdr"])) and m["nfe"] == CHECK_NFE for m in merged), merged
    log(f"[ddp] ranks bit-identical after each of {len(reports[0]['digests'])} optimizer steps; one checkpoint, by "
        f"rank 0; test.json merged from parts of {[len(p) for p in parts]} in order")

    # 2. the DDP update against one process on the whole batch
    one = small_ddp_updates(dev)
    ranks = [torch.load(ddp_dir / f"small_rank{r}.pt", weights_only=False) for r in range(DDP_RANKS)]
    small = {}
    for kind in ("train", "distill"):
        got = ranks[0][kind]
        assert all(all(torch.equal(a, b) for a, b in zip(r[kind]["mu"] + r[kind]["nu"], got["mu"] + got["nu"]))
                   for r in ranks), kind
        small[kind] = dict(
            loss_rel_err=max(abs(g - w) / abs(w) for g, w in zip(got["losses"], one[kind]["losses"])),
            grad_norm_rel_err=max(abs(g - w) / w for g, w in zip(got["grad_norms"], one[kind]["grad_norms"])),
            mu_rel_err=rel_err(got["mu"], one[kind]["mu"]), nu_rel_err=rel_err(got["nu"], one[kind]["nu"]),
            tol=DDP_TOL)
        log(f"[ddp] nf=32 f32 {kind} step, {DDP_RANKS} ranks (DDP, {backend}) vs one process on the whole batch: "
            f"loss {small[kind]['loss_rel_err']:.3g}, grad norm {small[kind]['grad_norm_rel_err']:.3g} relative; "
            f"Adam mu {small[kind]['mu_rel_err']:.3g}, nu {small[kind]['nu_rel_err']:.3g} of their norms "
            f"(tol {DDP_TOL:g}); ranks bit-identical")
        assert all(v <= DDP_TOL for k, v in small[kind].items() if k != "tol"), small[kind]
    out["small_f32_ddp_check"] = small

    # 3. the published all-GPU trainer file, unmodified, for 2 micro-steps
    _build.reset_counts()
    ov = ["experiment=icassp-separation", f"path.datasets.wsj0_mix={data}", f"path.exp_root={tmp}/exp_allgpus",
          "trainer.max_steps=2", "model.valid_max_sep_batches=1"]
    t0 = time.perf_counter()
    state = train_cli.main(ov)
    torch.cuda.synchronize()
    run_all = next(Path(tmp, "exp_allgpus").glob("*/*/train_log.jsonl")).parent
    launches = dict(_build.launch_counts)
    total.update(launches)
    shapes |= set(_build.launch_shapes)
    out["allgpus"] = dict(seconds=time.perf_counter() - t0, devices=torch.cuda.device_count(), launches=launches,
                          checkpoints=sorted(json.loads((run_all / "checkpoints" / "index.json").read_text())))
    log(f"[ddp] cli.train {' '.join(ov)} (trainer=allgpus, devices -1 = {torch.cuda.device_count()} GPU): "
        f"{out['allgpus']['seconds']:.1f} s, checkpoints {out['allgpus']['checkpoints']}, launches {launches}")
    assert out["allgpus"]["checkpoints"] == ["2"], out["allgpus"]
    if torch.cuda.device_count() == 1:
        assert state.step == 2 and all(launches.get(k, 0) > 0 for k in PER_EVAL), (state.step, launches)

    # 4. preemption: SIGTERM a cli.train child after its third micro-step,
    # then resume in this process; 5. with the profiler on
    data_p = write_wsj0_mix(Path(tmp) / "wsj0_mix_preempt", {"train": 3 * PREEMPT_BATCH, "val": 1},
                            seconds=1, fs=FS, seed=12)
    base = ["experiment=icassp-separation", f"path.datasets.wsj0_mix={data_p}", "trainer.devices=1",
            "trainer.check_val_every_n_epoch=1000", f"datamodule.train.dl_opts.batch_size={PREEMPT_BATCH}",
            *PREEMPT_WIDTH]
    ov = [*base, f"path.exp_root={tmp}/exp_preempt", "trainer.max_steps=1000"]
    code = ("import atexit, json, runpy, sys; from diffsep_tpu_torch.ops import _build; "
            "atexit.register(lambda: print('LAUNCHES', json.dumps(dict(_build.launch_counts)), file=sys.stderr)); "
            "runpy.run_module('diffsep_tpu_torch.cli.train', run_name='__main__', alter_sys=True)")
    child = subprocess.Popen([sys.executable, "-c", code, *ov], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, cwd=Path(__file__).resolve().parent)
    t0 = time.perf_counter()
    try:
        while not list(Path(tmp).glob("exp_preempt/*/*/train_log.jsonl")):  # the first epoch: 3 micro-steps
            assert child.poll() is None, child.communicate()[1][-3000:]
            assert time.perf_counter() - t0 < 300, "no epoch after 300 s"
            time.sleep(0.1)
        child.send_signal(signal.SIGTERM)
        _, err = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, err[-3000:]
    launches = json.loads(err.rsplit("LAUNCHES", 1)[1].splitlines()[0])
    total.update(launches)
    run_p = next(Path(tmp).glob("exp_preempt/*/*/train_log.jsonl")).parent
    index = json.loads((run_p / "checkpoints" / "index.json").read_text())
    (saved,) = [int(k) for k in index]
    assert saved >= 3 and index[str(saved)] == {} and not (run_p / "checkpoints" / "best-model.pt").exists(), index
    _build.reset_counts()
    resumed = train_cli.main([*base, f"path.exp_root={tmp}/exp_resume", f"trainer.max_steps={saved + 2}",
                              f"trainer.resume_from_checkpoint={run_p}", "trainer.profiler=true"])
    torch.cuda.synchronize()
    launches_r = dict(_build.launch_counts)
    total.update(launches_r)
    shapes |= set(_build.launch_shapes)  # the child's, at the same width and batch
    run_r = next(Path(tmp).glob("exp_resume/*/*/train_log.jsonl")).parent
    traces = sorted((run_r / "profile").glob("*.json"))
    out["preempt"] = dict(seconds=time.perf_counter() - t0, saved_step=saved, resumed_step=resumed.step,
                          launches=launches, resume_launches=launches_r,
                          trace_mb=[p.stat().st_size / 1e6 for p in traces])
    log(f"[ddp] preemption: SIGTERM after micro-step 3 of a cli.train child; checkpoint at step {saved} (no metrics, "
        f"no best-model); resumed in this process to step {resumed.step} with trainer.profiler=true: trace "
        f"{[p.name for p in traces]} ({out['preempt']['trace_mb']} MB); launches {launches}, resumed {launches_r}")
    assert resumed.step == saved + 2 and not resumed.preempted and traces, out["preempt"]
    assert all(launches.get(k, 0) > 0 for k in PER_EVAL) and all(launches_r.get(k, 0) > 0 for k in PER_EVAL)

    # 6. cli.evaluate_mp on phase 6's run dir, per utterance and batched
    write_wsj0_mix(data, {"test": EVAL_MP_FILES}, seconds=SERVE_SECONDS, fs=FS, seed=13)
    out["evaluate_mp"] = {}
    d_args = [str(c) for c in cards]
    batched = ["--batch-size", str(EVAL_MP_BATCH)]
    # (label, -d, other flags, files, sampler runs): two workers, then one
    # worker beside them in the same call (per utterance on half the files)
    for label, d, mode, files, runs in (
            (f"{DDP_RANKS} workers, per utterance", d_args, ["-l", str(DDP_RANKS)], DDP_RANKS, DDP_RANKS),
            (f"{DDP_RANKS} workers, --batch-size {EVAL_MP_BATCH}", d_args, batched, EVAL_MP_FILES,
             DDP_RANKS * -(-EVAL_MP_FILES // (DDP_RANKS * EVAL_MP_BATCH))),
            ("1 worker, per utterance", ["0"], ["-l", str(EVAL_MP_FILES // 2)], EVAL_MP_FILES // 2,
             EVAL_MP_FILES // 2),
            (f"1 worker, --batch-size {EVAL_MP_BATCH}", ["0"], batched, EVAL_MP_FILES,
             -(-EVAL_MP_FILES // EVAL_MP_BATCH))):
        argv = [str(run_dir), "-d", *d, "-N", str(CHECK_N), "-o", str(Path(tmp) / "eval_mp"), *mode]
        torch.cuda.synchronize()
        _build.reset_counts()
        t0 = time.perf_counter()
        out_dir = evaluate_mp.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
        total.update(launches)
        shapes |= set(_build.launch_shapes)
        records = json.loads((out_dir / "test.json").read_text())
        runtime = [r["runtime"] for r in records.values()]
        out["evaluate_mp"][label] = dict(wall_s=wall, s_per_utt_wall=wall / files,
                                         s_per_utt_runtime=float(np.mean(runtime)), runtime=runtime, runs=runs,
                                         launches=launches, dir=out_dir.name)
        log(f"[ddp] cli.evaluate_mp RUN_DIR -d {' '.join(d)} -N {CHECK_N} {' '.join(mode)} ({label}): {files} "
            f"files of {SERVE_SECONDS} s in {wall:.1f} s with loading = {wall / files:.3f} s per utterance; "
            f"runtime per utterance {np.mean(runtime):.3f} s (min {min(runtime):.3f}, max {max(runtime):.3f}); "
            f"{runs} sampler runs, launches {launches} ({card})")
        assert list(records) == [str(i) for i in range(files)], list(records)
        assert all(r["nfe"] == CHECK_NFE and np.isfinite(np.mean(r["si_sdr"])) for r in records.values())
        assert launches == {k: v * CHECK_NFE * runs for k, v in PER_EVAL.items()}, launches
    # every kernel shape of these runs that earlier phases did not hold
    checks = []
    for i, (k, shape, cout) in enumerate(sorted(shapes - checked, key=str)):
        r = check_kernel(k, shape, cout, "bfloat16", dev, 1000 + i, None, timed=False)
        checks.append(r)
        log(f"[ddp-kernel] {k} {shape}->{cout} bf16:{plan_text(r['plan'])} err {r['max_abs_err']:.3g} "
            f"(tol {r['tol']:.3g}) untimed")
    out["kernel_checks"] = checks
    bad = [r for r in checks if not r["ok"]]
    assert not bad, f"kernel mismatches at phase 10's shapes: {bad}"
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = dict(total)
    log(f"[ddp] {len(checks)} new kernel shapes held; phase 10 took {out['seconds']:.1f} s; launches {dict(total)}")
    return out, dict(total)


# --- phase 11: the DiffuSE recipe (model=diffuse) --------------------------
def card_vs_cpu(make, inputs, seed, dev):
    """A module built twice by ``make(device)`` with the CPU copy's weights
    randomized (``randomize_``) and copied to the card; the same inputs
    through both, forward and the gradients of sum(out * w) for a seeded w.
    Returns (output error over its scale, gradient error over the norm,
    scale, the card's module). The CPU copy is built from ``seed`` too:
    ``randomize_`` adds to a vector's initial value, and an RNN draws its
    biases from the global generator, so without it every run checked
    other weights."""
    import torch

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        cpu = make("cpu")
    randomize_(cpu, seed)
    gpu = make(dev)
    gpu.load_state_dict(cpu.state_dict())
    outs, grads = {}, {}
    for name, m, d in (("cpu", cpu, "cpu"), ("card", gpu, dev)):
        m.zero_grad()
        out = m(*[x.to(d) for x in inputs])
        w = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed + 1)).to(d)
        (out * w).sum().backward()
        outs[name] = out.detach().cpu()
        grads[name] = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
                       for k, p in m.named_parameters()}
    scale = outs["cpu"].abs().max().item()
    norm = sum(float(g.double().square().sum()) for g in grads["cpu"].values()) ** 0.5
    grad_err = max(float((grads["card"][k] - g).abs().max()) for k, g in grads["cpu"].items()) / norm
    return (outs["card"] - outs["cpu"]).abs().max().item() / scale, grad_err, scale, gpu


def diffuse_flops(model, n_samples):
    """Operations (2 x multiply-adds) of one DiffuSE evaluation on
    ``n_samples`` samples (batch x time): its convolutions, each weight
    element once per sample; the step embedding's dense layers, once per
    row, add under 0.01%."""
    import torch

    return 2 * n_samples * sum(m.weight.numel() for m in model.modules() if isinstance(m, torch.nn.Conv1d))


def diffuse_phase(dev, card, cycles_per_ms, tmp):
    """Phase 11: the DiffuSE recipe at full width through its entry points,
    in the directory ``tmp``; see the module docstring. Returns (report,
    launches of the hand kernels over the phase: none)."""
    import argparse

    import torch

    from diffsep_tpu_torch.cli import distill as distill_cli
    from diffsep_tpu_torch.cli import evaluate as eval_cli
    from diffsep_tpu_torch.cli import export_model as export_cli
    from diffsep_tpu_torch.cli import serve as serve_cli
    from diffsep_tpu_torch.cli import train as train_cli
    from diffsep_tpu_torch.cli.loading import load_model
    from diffsep_tpu_torch.cli.serve_http import HTTPSeparationServer
    from diffsep_tpu_torch.config import compose
    from diffsep_tpu_torch.data.audio_io import load_wav_bytes, wav_to_bytes
    from diffsep_tpu_torch.data.synthetic import write_wsj0_mix
    from diffsep_tpu_torch.export import load_separator
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.models import DPTNet, TemporalConvNet
    from diffsep_tpu_torch.ops import _build
    from diffsep_tpu_torch.train import distill

    out = {}
    t_phase = time.perf_counter()
    tf32 = dict(cudnn=torch.backends.cudnn.allow_tf32, matmul=torch.backends.cuda.matmul.allow_tf32)
    out["tf32"] = tf32
    log(f"[diffuse] TF32 allowed: cuDNN {tf32['cudnn']}, matmul {tf32['matmul']} (every timed run below)")
    _build.reset_counts()  # no hand kernel may launch in this phase
    torch.cuda.empty_cache()

    # a. the full-width score and its parameter gradients, card against CPU
    cfg = compose(["model=diffuse"])
    n = SERVE_SECONDS * FS
    g = torch.Generator().manual_seed(31)
    xt = 0.5 * torch.randn((SERVE_BATCH, 2, n), generator=g)
    mix = 0.5 * torch.randn((SERVE_BATCH, 1, n), generator=g)
    t = torch.tensor([0.37, 1.0])
    t0 = time.perf_counter()
    score_err, grad_err, scale, score_model = card_vs_cpu(
        lambda d: DiffSepModel(cfg, device=d, seed=3).score_model, (xt, t, mix), 32, dev)
    check_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in score_model.parameters())
    xt_d, t_d, mix_d = xt.to(dev), t.to(dev), mix.to(dev)

    def evaluate():
        with torch.no_grad():
            score_model(xt_d, t_d, mix_d)

    device_ms = time_ms(evaluate, cycles_per_ms)
    evaluate()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DIFFUSE_EVALS):
        evaluate()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / DIFFUSE_EVALS
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / DIFFUSE_EVALS
    flops = diffuse_flops(score_model, SERVE_BATCH * n)
    bound_ms = flops / PEAK_FLOPS["float32"] * 1e3
    out["check"] = dict(parameters=n_params, score_rel_err=score_err, grad_rel_err=grad_err, scale=scale,
                        tol=DIFFUSE_TOL, seconds=check_s)
    out["evaluation"] = dict(batch=SERVE_BATCH, seconds=SERVE_SECONDS, device_ms=device_ms, wall_ms=wall_ms,
                             enqueue_ms=enqueue_ms, idle_share=1.0 - device_ms / wall_ms, tflop=flops / 1e12,
                             bound_ms=bound_ms, tflops=flops / device_ms / 1e9)
    bb = cfg.model.score_model.backbone_args
    log(f"[diffuse] model=diffuse: DiffuSE {bb.residual_layers} x {bb.residual_channels}, dilation cycle "
        f"{bb.dilation_cycle_length}, embedding {bb.embedding_len}, {n_params} parameters, float32")
    log(f"[diffuse] card vs CPU at {SERVE_BATCH} x {SERVE_SECONDS} s, randomized weights: score {score_err:.3g} of "
        f"scale {scale:.3g} (tol {DIFFUSE_TOL['score']}), parameter gradients {grad_err:.3g} of their norm "
        f"(tol {DIFFUSE_TOL['grad']}); {check_s:.1f} s")
    log(f"[diffuse] one evaluation at {SERVE_BATCH} x {SERVE_SECONDS} s: device {device_ms:.3f} ms "
        f"({flops / 1e12:.4f} TFLOP, {flops / device_ms / 1e9:.2f} TFLOP/s; bound {bound_ms:.3f} ms at "
        f"{PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s f32), host enqueue {enqueue_ms:.3f} ms, wall {wall_ms:.3f} ms "
        f"over {DIFFUSE_EVALS} back to back, idle share {1.0 - device_ms / wall_ms:.3f} ({card})")
    assert score_err <= DIFFUSE_TOL["score"] and grad_err <= DIFFUSE_TOL["grad"], (score_err, grad_err)
    del score_model

    # b. cli.train model=diffuse as composed (batch 16 x 5 s, accumulation
    # 2, Adam 2e-4, clip 5, EMA 0.999), one validation, one checkpoint
    data = write_wsj0_mix(Path(tmp) / "diffuse_wsj0_mix", {"train": DIFFUSE_BATCH, "val": 2, "test": DIFFUSE_TEST},
                          seconds=SERVE_SECONDS, fs=FS, seed=1)
    steps = DIFFUSE_WARMUP + DIFFUSE_TIMED
    overrides = ["model=diffuse", f"path.datasets.wsj0_mix={data}", f"path.exp_root={tmp}/exp_diffuse",
                 f"trainer.max_steps={steps}", f"trainer.check_val_every_n_epoch={steps}"]
    log(f"[diffuse] python -m diffsep_tpu_torch.cli.train {' '.join(overrides)}")
    per_step = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(DiffSepModel, "make_train_step", counting_train_step(per_step)):
        state = train_cli.main(overrides)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run_dir = next(Path(tmp, "exp_diffuse").glob("*/*/train_log.jsonl")).parent
    index = json.loads((run_dir / "checkpoints" / "index.json").read_text())
    assert state.step == steps and len(per_step) == steps and list(index) == [str(steps)], (state.step, index)
    speed, rows = train_speed(run_dir, DIFFUSE_WARMUP, DIFFUSE_TIMED, DIFFUSE_BATCH)
    losses = [r["train/score_loss"] for r in rows]
    peak = max(s["peak_gib"] for s in per_step)
    assert all(s["batch"] == [DIFFUSE_BATCH, 1, n] for s in per_step), [s["batch"] for s in per_step]
    assert all(np.isfinite(losses)) and all(np.isfinite(v) for v in index[str(steps)].values()), (losses, index)
    assert all(not s["launches"] for s in per_step), [s["launches"] for s in per_step]
    out["train"] = dict(batch=DIFFUSE_BATCH, run_s=run_s, **speed, peak_gib=peak, losses=losses,
                        validation=index[str(steps)], ema_updates=state.ema.num_updates)
    log(f"[diffuse] train: {steps} micro-steps of {DIFFUSE_BATCH} x {SERVE_SECONDS} s in {run_s:.1f} s with "
        f"validation and checkpoint; timed {DIFFUSE_TIMED} after {DIFFUSE_WARMUP}: "
        f"{speed['ms_per_micro_step']:.2f} ms per micro-step, {speed['samples_per_s']:.3f} samples/s, peak "
        f"{peak:.2f} GiB ({card}); losses {[f'{v:.5g}' for v in losses]}; validation {index[str(steps)]}")
    del state

    # c. separation with the run's EMA weights
    model = load_model(run_dir, device=dev)
    mix_d = (0.1 * torch.randn((SERVE_BATCH, 1, n), generator=torch.Generator().manual_seed(34))).to(dev)
    sep = {}
    for label, kw in [("reverse_diffusion+ald2 N=30", dict(N=30)),
                      ("ddim+none N=6", dict(predictor_name="ddim", corrector_name="none", N=6))]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        est, nfe = model.separate(mix_d, generator=torch.Generator(device=dev).manual_seed(0), **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        assert est.shape == (SERVE_BATCH, 2, n) and torch.isfinite(est).all(), label
        sep[label] = dict(nfe=nfe, seconds=secs, utt_per_s=SERVE_BATCH / secs, ms_per_eval=secs * 1e3 / nfe,
                          peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(f"[diffuse] separate {label}: {SERVE_BATCH} x {SERVE_SECONDS} s in {secs:.3f} s = "
            f"{SERVE_BATCH / secs:.3f} utt/s, {nfe} evaluations ({secs * 1e3 / nfe:.2f} ms each), peak "
            f"{sep[label]['peak_mem_gib']:.2f} GiB ({card})")
    out["separate"] = sep
    del model

    # d. cli.serve's engine on the run dir, as `--http` builds it, and a
    # burst of concurrent requests of seeded 3-6 s lengths
    engine = serve_cli._engine_from_args(argparse.Namespace(
        model=run_dir, device=str(dev), N=None, snr=None, corrector_steps=None, predictor=None, corrector=None,
        batch=4, bucket_s=1.0, seed=0))
    rng = np.random.default_rng(35)
    lengths = rng.integers(HTTP_SECONDS[0] * FS, HTTP_SECONDS[1] * FS + 1, size=DIFFUSE_HTTP)
    good = [(0.1 * rng.standard_normal((1, int(m)))).astype(np.float32) for m in lengths]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with HTTPSeparationServer(engine, port=0, max_queue=64) as srv:
        results, wall = http_burst(srv.port, [wav_to_bytes(w, FS) for w in good])
        metrics = scrape_metrics(srv.port)
    lat = [r[2] for r in results if r[0] == 200]
    resets = [r[3] for r in results if r[3] is not None]
    for w, (status, body, _, err) in zip(good, results):
        assert status == 200, (status, body[:200], err)
        est, sr = load_wav_bytes(body)
        assert sr == FS and est.shape == (2, w.shape[-1]) and np.isfinite(est).all(), (sr, est.shape)
    assert not resets, resets
    out["http"] = dict(requests=DIFFUSE_HTTP, lengths_s=[int(m) / FS for m in lengths], wall_s=wall,
                       requests_per_s=len(lat) / wall, latency_s=percentiles(lat), connection_resets=len(resets),
                       program_runs=int(metrics["diffsep_batch_fill_count"]),
                       peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[diffuse] http: {DIFFUSE_HTTP} concurrent requests of {HTTP_SECONDS[0]}-{HTTP_SECONDS[1]} s, batch 4, "
        f"reverse_diffusion+ald2 N=30: {len(lat) / wall:.3f} requests/s, latency p50 "
        f"{out['http']['latency_s']['p50']:.3f} max {out['http']['latency_s']['max']:.3f} s, "
        f"{out['http']['program_runs']} program runs, {len(resets)} connection resets, peak "
        f"{out['http']['peak_mem_gib']:.2f} GiB ({card})")
    del engine

    # e. cli.evaluate on the test split at N=30
    res_dir = Path(tmp) / "eval_diffuse"
    t0 = time.perf_counter()
    eval_cli.main([str(run_dir), "--test", "-N", "30", "--save-n", "0", "-o", str(res_dir), "--device", str(dev)])
    secs = time.perf_counter() - t0
    (res,) = [p for p in res_dir.iterdir() if p.is_dir()]
    records = json.loads((res / "test.json").read_text())
    assert len(records) == DIFFUSE_TEST and all(set(r) >= RECORD_KEYS for r in records), records[:1]
    assert all(np.isfinite(np.asarray(r["si_sdr"], float)).all() and r["nfe"] == PROD_NFE for r in records)
    runtime = float(np.mean([r["runtime"] for r in records]))
    out["evaluate"] = dict(files=DIFFUSE_TEST, seconds=secs, s_per_utt=secs / DIFFUSE_TEST, mean_runtime_s=runtime)
    log(f"[diffuse] cli.evaluate RUN --test -N 30: {DIFFUSE_TEST} files of {SERVE_SECONDS} s in {secs:.1f} s "
        f"with loading = {secs / DIFFUSE_TEST:.3f} s per utterance (mean record runtime {runtime:.3f} s) ({card})")

    # f. cli.distill N=4 -> 2 on the run's data, then the N=2 artifact
    dist_root = Path(tmp) / "distilled_diffuse"
    argv = [str(run_dir), "--stages", "4,2", "--steps", str(DIFFUSE_DISTILL_STEPS), "--schedule", "log",
            "--out", str(dist_root), "--log-every", "1", "--device", str(dev)]
    log(f"[diffuse] python -m diffsep_tpu_torch.cli.distill {' '.join(argv)}")
    d_steps, ends = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(distill, "make_distill_step", counting_distill_step(d_steps)), \
            mock.patch.object(distill, "distill_stage", synced_distill_stage(ends)):
        distill_cli.main(argv)
    d_run = time.perf_counter() - t0
    d_losses = [float(s["loss"]) for s in d_steps]
    assert len(d_steps) == 2 * DIFFUSE_DISTILL_STEPS and all(np.isfinite(d_losses)), d_losses
    d_ms = [(ends[si] - d_steps[si * DIFFUSE_DISTILL_STEPS + 1]["start"]) * 1e3 / (DIFFUSE_DISTILL_STEPS - 1)
            for si in range(2)]
    student = dist_root / "N2"
    art = Path(tmp) / "diffuse_n2.dst"
    t0 = time.perf_counter()
    export_cli.main([str(student), "-o", str(art), "--batch", str(SERVE_BATCH), "--len-s", str(SERVE_SECONDS),
                     "--device", str(dev)])
    export_s = time.perf_counter() - t0
    sep_art = load_separator(art)
    mix_np = (0.1 * np.random.default_rng(36).standard_normal((SERVE_BATCH, 1, n))).astype(np.float32)
    calls = []
    for _ in range(ART_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est = sep_art.call(21, mix_np)
        torch.cuda.synchronize()
        calls.append(time.perf_counter() - t0)
    live = load_model(student, device=dev)
    want, _ = live.separate_masked(mix_np, [n] * SERVE_BATCH, generator=torch.Generator(device=dev).manual_seed(21))
    diff = (est - want).abs().max().item()
    assert torch.isfinite(est).all() and diff <= 1e-5 * want.abs().max().item(), diff
    out["distill"] = dict(steps=DIFFUSE_DISTILL_STEPS, run_s=d_run, ms_per_step=d_ms, losses=d_losses,
                          samples_per_s=[DIFFUSE_BATCH * 1e3 / m for m in d_ms],
                          peak_gib=max(s["peak_gib"] for s in d_steps))
    out["artifact"] = dict(export_s=export_s, mb=art.stat().st_size / 1e6, call_s=calls,
                           utt_per_s=[SERVE_BATCH / s for s in calls], max_abs_vs_live=diff)
    log(f"[diffuse] distill N=4 -> 2, {DIFFUSE_DISTILL_STEPS} steps each of {DIFFUSE_BATCH} x {SERVE_SECONDS} s: "
        f"{', '.join(f'{m:.2f}' for m in d_ms)} ms per step after the first, peak "
        f"{out['distill']['peak_gib']:.2f} GiB ({card}); losses {[f'{v:.5g}' for v in d_losses]}")
    log(f"[diffuse] artifact N=2 at {SERVE_BATCH} x {SERVE_SECONDS} s: {art.stat().st_size / 1e6:.2f} MB, exported "
        f"in {export_s:.1f} s; {', '.join(f'{SERVE_BATCH / s:.3f}' for s in calls)} utt/s ({card}); against the "
        f"live separate_masked on the same seed: {diff:.3g}{' (bit for bit)' if diff == 0.0 else ''}")
    del live, sep_art

    # g. the library backbones, card against CPU at small sizes (train mode,
    # dropout 0: cuDNN's RNN backward runs only in training mode)
    aux = {}
    g2 = torch.Generator().manual_seed(37)
    w_in = torch.randn((2, 64, 400), generator=g2)
    for norm, causal in (("gLN", False), ("cLN", True), ("BN", False)):
        aux[f"TemporalConvNet {norm}{' causal' if causal else ''}"] = card_vs_cpu(
            lambda d: TemporalConvNet(N=64, B=32, H=64, P=3, X=4, R=2, C=2, norm_type=norm, causal=causal).to(d),
            (w_in,), 38, dev)[:3]
    x_in = torch.randn((2, 16, 50, 20), generator=g2)
    for rnn, bi in (("LSTM", True), ("GRU", False), ("RNN", True)):
        aux[f"DPTNet {rnn}{' bidirectional' if bi else ''}"] = card_vs_cpu(
            lambda d: DPTNet(rnn, 16, 32, 16, att_heads=4, num_layers=2, bidirectional=bi).to(d),
            (x_in,), 39, dev)[:3]
    out["aux_models"] = {k: dict(out_rel_err=a, grad_rel_err=b, scale=s) for k, (a, b, s) in aux.items()}
    for k, (a, b, _) in aux.items():
        log(f"[diffuse] {k}, card vs CPU: output {a:.3g} of scale, gradients {b:.3g} of their norm")
    assert all(a <= DIFFUSE_TOL["score"] and b <= DIFFUSE_TOL["grad"] for a, b, _ in aux.values()), aux

    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    assert not counts, f"hand kernels launched on the DiffuSE path: {counts}"
    out["launches"] = {k: 0 for k in KERNELS}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[diffuse] no hand kernel launched ({', '.join(KERNELS)}: 0); phase 11 took {out['seconds']:.1f} s")
    return out, out["launches"]


# --- phase 12: the NCSN++ options ------------------------------------------
def option_config(name, small=False):
    """The model overrides of option set ``name`` (OPTION_SETS), at the
    flagship's width, or at nf=32 in float32 (``small``)."""
    backbone, frontend = OPTION_SETS[name]
    frontend = dict(frontend)
    sm = {"backbone_args": dict(backbone, **(SMALL_BACKBONE if small else {})),
          "stft_args": frontend.pop("stft_args", {}), **frontend}
    return {"score_model": sm}


@contextlib.contextmanager
def recording_kernels(seen):
    """Each call of a kernel wrapper counted into ``seen`` under (kernel,
    input shape, output channels, dtype name), the key that ``check_kernel``
    takes; the wrappers themselves run as always."""
    from diffsep_tpu_torch.ops import conv3x3 as conv_mod
    from diffsep_tpu_torch.ops import fir_resample2x as fir_mod

    def recorder(mod, name):
        real = getattr(mod, name)

        def call(x, *args, **kwargs):
            cout = args[0].shape[3] if name == "conv3x3" else None
            seen[name, tuple(x.shape), cout, str(x.dtype).rpartition(".")[2]] += 1
            return real(x, *args, **kwargs)

        return mock.patch.object(mod, name, call)

    with contextlib.ExitStack() as stack:
        for mod, name in [(conv_mod, "conv3x3"), (fir_mod, "fir_down2x"), (fir_mod, "fir_up2x")]:
            stack.enter_context(recorder(mod, name))
        yield


def randomized_model(config, dev, seed):
    """A DiffSepModel of ``config`` on ``dev`` with unit-scale random weights
    (``randomize_`` on a CPU copy, loaded onto the card)."""
    from diffsep_tpu_torch.model import DiffSepModel

    cpu = DiffSepModel(config, device="cpu", seed=seed)
    randomize_(cpu.score_model, seed=seed + 1)
    model = DiffSepModel(config, device=dev, seed=seed)
    model.score_model.load_state_dict(cpu.score_model.state_dict())
    return model


def busy_and_host_ms(run, n):
    """Device busy ms per call (torch.profiler's CUDA kernel and copy time
    over ``n`` calls), host enqueue ms and wall ms per call over ``n``
    unprofiled back-to-back calls, the idle share 1 - busy / wall, the
    device ms by kernel group (OPTION_GROUPS) and of the largest kernels,
    and the calls per run of the framework's convolution ops
    (FRAMEWORK_CONV_OPS)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        run()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    kernels, framework = [], {}
    for e in prof.key_averages():
        if e.key in FRAMEWORK_CONV_OPS:
            framework[e.key] = e.count / n
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            kernels.append((dev_us / 1e3 / n, e.count / n, e.key))
    kernels.sort(reverse=True)
    groups = {name: 0.0 for name, _ in OPTION_GROUPS}
    groups["other"] = 0.0
    def group_of(name):
        return next((g for g, frags in OPTION_GROUPS if any(f in name for f in frags)), "other")

    for ms, _, name in kernels:
        groups[group_of(name)] += ms
    busy = sum(k[0] for k in kernels)
    return dict(device_busy_ms=busy, enqueue_ms=enqueue_ms, wall_ms=wall_ms, idle_share=1.0 - busy / wall_ms,
                device_ms_by_group=groups, framework_conv_calls=framework,
                top_kernels=[dict(ms=ms, launches=c, name=name[:100]) for ms, c, name in kernels[:8]])


def busy_text(r):
    groups = ", ".join(f"{k} {v:.2f}" for k, v in r["device_ms_by_group"].items())
    return (f"device busy {r['device_busy_ms']:.3f} ms ({groups}), host enqueue {r['enqueue_ms']:.3f} ms, "
            f"wall {r['wall_ms']:.3f} ms, idle share {r['idle_share']:.3f}")


def options_phase(dev, card, cycles_per_ms, tmp, data, checked):
    """Phase 12: the NCSN++ options at full width; see the module docstring.
    ``data`` is phase 6's synthetic WSJ0-mix folder, ``checked`` the
    (kernel, shape, cout, dtype) keys earlier phases held against the plain
    versions. Returns (report, launches over the phase's main-path runs)."""
    import torch

    from diffsep_tpu_torch.cli import export_model as export_cli
    from diffsep_tpu_torch.cli import separate as sep_cli
    from diffsep_tpu_torch.cli import train as train_cli
    from diffsep_tpu_torch.cli.loading import load_model
    from diffsep_tpu_torch.data.audio_io import load_wav
    from diffsep_tpu_torch.export import load_separator
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.models import layers
    from diffsep_tpu_torch.ops import _build
    from diffsep_tpu_torch.ops.plain import plain_kernels
    from diffsep_tpu_torch.train.checkpoints import load_payload
    from diffsep_tpu_torch.train.losses import Draws
    from diffsep_tpu_torch.train.trainer import make_loss_fn

    out, total, checks = {"sets": {}}, collections.Counter(), []
    t_phase = time.perf_counter()

    def counted(label, want):
        torch.cuda.synchronize()
        got = {k: v for k, v in _build.launch_counts.items() if v}
        total.update(got)
        want = {k: v for k, v in want.items() if v}
        assert got == want, (label, got, want)
        return got

    def hold(seen, label, per_step=None):
        """Every kernel call in ``seen`` that no phase has held yet, against
        its plain version on the card: untimed, or, given the calls of one
        micro-step (``per_step``), timed beside the library call."""
        new = sorted(k for k in seen if k not in checked)
        for i, (kind, shape, cout, dtype_name) in enumerate(new):
            r = check_kernel(kind, shape, cout, dtype_name, dev, 300 + len(checks), cycles_per_ms,
                             timed=per_step is not None)
            r["path"] = label
            times = ""
            if per_step is not None:
                r["launches_per_micro_step"] = per_step[kind, shape, cout, dtype_name]
                times = (f" x{r['launches_per_micro_step']} ms {r['ms']:.4f} plain {r['plain_ms']:.4f} "
                         f"lib {r['library_ms']:.4f}{f32_lib_text(r)} bound {r['bound_ms'] * 1e3:.3f} us")
            checks.append(r)
            checked.add((kind, shape, cout, dtype_name))
            log(f"[options-kernel] {label}: {kind} {list(shape)}->{cout} {dtype_name}:{plan_text(r['plan'])} "
                f"err {r['max_abs_err']:.3g} (tol {r['tol']:.3g}){times}")
        return len(new)

    n = SERVE_SECONDS * FS
    rng = np.random.default_rng(40)
    xt = torch.from_numpy((0.3 * rng.standard_normal((SERVE_BATCH, 2, n))).astype(np.float32)).to(dev)
    mix = torch.from_numpy((0.3 * rng.standard_normal((SERVE_BATCH, 1, n))).astype(np.float32)).to(dev)
    t = torch.tensor([0.4, 0.9], device=dev)
    xs = torch.from_numpy(rng.standard_normal((1, 2, FS)).astype(np.float32))
    ms_ = torch.from_numpy(rng.standard_normal((1, 1, FS)).astype(np.float32))
    ts = torch.tensor([0.4])
    s_rng = np.random.default_rng(41)
    tgt_set = torch.from_numpy(0.1 * s_rng.standard_normal((SERVE_BATCH, 2, n), dtype=np.float32)).to(dev)
    mix_set = tgt_set.sum(dim=1, keepdim=True)
    set_draws = {"mask": torch.tensor([0.05, 0.5], device=dev),
                 "z0": torch.from_numpy(s_rng.standard_normal((SERVE_BATCH, 2, n), dtype=np.float32)).to(dev),
                 "z": torch.from_numpy(s_rng.standard_normal((SERVE_BATCH, 2, n), dtype=np.float32)).to(dev),
                 "shuffle": torch.from_numpy(s_rng.uniform(size=(SERVE_BATCH, 2)).astype(np.float32)).to(dev),
                 "time": torch.from_numpy(s_rng.uniform(size=SERVE_BATCH).astype(np.float32)).to(dev)}
    models = {}
    for i, name in enumerate(OPTION_SETS):
        # a. one full-width evaluation: launches, kernel shapes, times
        model = randomized_model(option_config(name), dev, 40 + 2 * i)
        seen = collections.Counter()

        def evaluate():
            with torch.no_grad():
                return model.score_fn(xt, t, mix)

        _build.reset_counts()
        with recording_kernels(seen):
            score = evaluate()
        got = counted(f"set {name}", OPTION_PER_EVAL[name])
        assert score.shape == (SERVE_BATCH, 2, n) and torch.isfinite(score).all(), name
        n_new = hold(seen, f"set {name}")
        _build.reset_counts()
        speed = busy_and_host_ms(evaluate, OPTION_EVALS)
        # a'. one micro-step of the set at 2 x 5 s: its float32 convs' dx and
        # dw on the hand kernels, its bf16 convs' on cuDNN
        _build.reset_counts()
        sm = model.score_model
        step_loss = make_loss_fn(sm, model.sde, model.loss_cfg)(Draws(None, set_draws), mix_set, tgt_set)
        step_loss.backward()
        torch.cuda.synchronize()
        sm.zero_grad(set_to_none=True)
        step_bwd = {k: v for k, v in _build.backward_counts.items() if k.startswith("conv3x3") and v}
        step_fwd = _build.launch_counts["conv3x3"] - _build.backward_counts["conv3x3"]
        total.update({k: v for k, v in _build.launch_counts.items() if v})
        want_bwd = dict(zip(("conv3x3", "conv3x3_dw"), OPTION_BWD[name]))
        assert np.isfinite(step_loss.item()) and step_fwd == OPTION_PER_EVAL[name]["conv3x3"] \
            and step_bwd == want_bwd, (name, step_fwd, step_bwd, want_bwd)
        step_loss_value = step_loss.item()
        del step_loss
        _build.reset_counts()
        dtypes = collections.Counter()
        for (kind, _, _, dt), cnt in seen.items():
            dtypes[f"{kind} {dt}"] += cnt
        # b. the same set at nf=32 in float32: card against CPU, kernels
        # against plain on the card
        small = {}
        m_cpu = DiffSepModel(option_config(name, small=True), device="cpu", seed=50 + i)
        randomize_(m_cpu.score_model, seed=51 + i)
        m_gpu = DiffSepModel(option_config(name, small=True), device=dev, seed=50 + i)
        m_gpu.score_model.load_state_dict(m_cpu.score_model.state_dict())
        with torch.no_grad():
            small["cpu"] = m_cpu.score_fn(xs, ts, ms_)
            _build.reset_counts()
            small["kernels"] = m_gpu.score_fn(xs.to(dev), ts.to(dev), ms_.to(dev)).cpu()
            small_launches = {k: v for k, v in _build.launch_counts.items() if v}
            with plain_kernels():
                _build.reset_counts()
                small["plain"] = m_gpu.score_fn(xs.to(dev), ts.to(dev), ms_.to(dev)).cpu()
                assert not any(_build.launch_counts.values()), dict(_build.launch_counts)
        scale = small["cpu"].abs().max().item()
        small_err = {"kernels vs cpu": (small["kernels"] - small["cpu"]).abs().max().item() / scale,
                     "kernels vs plain on the card": (small["kernels"] - small["plain"]).abs().max().item() / scale}
        assert all(torch.isfinite(v).all() for v in small.values()), name
        out["sets"][name] = dict(options=OPTION_SETS[name], launches_per_eval=got, kernel_calls_by_dtype=dict(dtypes),
                                 micro_step=dict(loss=step_loss_value, conv_forward=step_fwd, conv_backward=step_bwd),
                                 new_kernel_shapes=n_new, **speed, score_scale=score.abs().max().item(),
                                 small_f32=dict(rel_err=small_err, scale=scale, launches=small_launches))
        log(f"[options] set {name} {OPTION_SETS[name]}: launches per evaluation {got} ({dict(dtypes)}); "
            f"{n_new} new kernel shapes held; one evaluation at {SERVE_BATCH} x {SERVE_SECONDS} s over "
            f"{OPTION_EVALS}: {busy_text(speed)} ({card}); a micro-step at {SERVE_BATCH} x {SERVE_SECONDS} s: "
            f"conv3x3 {step_fwd} forward, backward {step_bwd} (f32 dx, dw)")
        log(f"[options] set {name} nf=32 f32: kernels vs cpu {small_err['kernels vs cpu']:.3g}, kernels vs plain "
            f"on the card {small_err['kernels vs plain on the card']:.3g} of scale {scale:.3g}; launches {small_launches}")
        assert small_err["kernels vs cpu"] <= 1e-3 and small_err["kernels vs plain on the card"] <= 2e-5, small_err
        assert small_launches, small_launches
        del m_cpu, m_gpu
        if name in OPTION_SEPARATE:
            models[name] = model
        else:
            del model
        torch.cuda.empty_cache()

    # c. separation with sets A and C: N=CHECK_N (reverse_diffusion + ald2) and
    # ddim N=6, 2 x 5 s
    sep_mix = 0.3 * mix
    for name in OPTION_SEPARATE:
        for label, kw in [(f"reverse_diffusion+ald2 N={CHECK_N}", dict(N=CHECK_N)),
                          ("ddim+none N=6", dict(predictor_name="ddim", corrector_name="none", N=6))]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_counts()
            t0 = time.perf_counter()
            est, nfe = models[name].separate(sep_mix, generator=torch.Generator(device=dev).manual_seed(1), **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = counted(f"set {name} {label}", {k: v * nfe for k, v in OPTION_PER_EVAL[name].items()})
            assert est.shape == (SERVE_BATCH, 2, n) and torch.isfinite(est).all(), (name, label)
            row = dict(nfe=nfe, seconds=secs, utt_per_s=SERVE_BATCH / secs, launches=got,
                       peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            out["sets"][name][f"separate {label}"] = row
            log(f"[options] set {name} separate {label}: {SERVE_BATCH} x {SERVE_SECONDS} s in {secs:.2f} s = "
                f"{row['utt_per_s']:.3f} utt/s, peak {row['peak_gib']:.2f} GiB, launches {got} ({card})")

    # d. set C through cli.export_model, served by cli.separate --model
    # ARTIFACT and held to the live separate_masked
    weights = Path(tmp) / "options_set_c.pt"
    torch.save({"state_dict": {k: v.cpu() for k, v in models["C"].score_model.state_dict().items()},
                "config": option_config("C")}, weights)
    del models
    torch.cuda.empty_cache()
    art = Path(tmp) / "options_set_c.dst"
    sampler = dict(predictor_name="ddim", corrector_name="none", N=ART_N)
    t0 = time.perf_counter()
    export_cli.main([str(weights), "-o", str(art), "--batch", str(SERVE_BATCH), "--len-s", str(SERVE_SECONDS),
                     "-N", str(ART_N), "--predictor", "ddim", "--corrector", "none"])
    export_s = time.perf_counter() - t0
    sep = load_separator(art)
    live = load_model(weights, device=dev)
    amix = (0.1 * rng.standard_normal((SERVE_BATCH, 1, n))).astype(np.float32)
    n_true = 3 * n // 5
    amix[1, :, n_true:] = 0.0
    n_valid = np.array([n, n_true])
    # cuDNN's transposed conv (set C's up path) may take a nondeterministic
    # algorithm: the artifact and the live model are held to each other with
    # the deterministic ones
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _build.reset_counts()
        t0 = time.perf_counter()
        est = sep.call(23, amix, n_valid)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        art_launches = counted("set C artifact call", {k: v * ART_N for k, v in OPTION_PER_EVAL["C"].items()})
        want, nfe = live.separate_masked(amix, n_valid, generator=torch.Generator(device=dev).manual_seed(23),
                                         **sampler)
    finally:
        torch.backends.cudnn.deterministic = prev
    diff, scale = (est - want).abs().max().item(), want.abs().max().item()
    assert nfe == ART_N and est.shape == (SERVE_BATCH, 2, n) and torch.isfinite(est).all()
    assert diff <= 1e-5 * scale and (est[1, :, n_true:] == 0).all(), (diff, scale)
    del live
    files = sorted((Path(data) / "2speakers/wav8k/max/cv/mix").iterdir())[:SERVE_BATCH]
    sep_in = Path(tmp) / "options_sep_in"
    sep_in.mkdir()
    for f in files:
        (sep_in / f.name).symlink_to(f)
    _build.reset_counts()
    t0 = time.perf_counter()
    sep_cli.main([str(sep_in), str(Path(tmp) / "options_sep_out"), "--model", str(art)])
    sep_s = time.perf_counter() - t0
    sep_launches = counted("set C artifact cli.separate", {k: v * ART_N for k, v in OPTION_PER_EVAL["C"].items()})
    for f in files:
        y, fs = load_wav(Path(tmp) / "options_sep_out" / "s1" / f.name)
        assert fs == FS and y.shape == load_wav(f)[0].shape and np.isfinite(y).all(), f.name
    out["set_c_artifact"] = dict(export_s=export_s, mb=art.stat().st_size / 1e6, call_s=call_s,
                                 utt_per_s=SERVE_BATCH / call_s, launches_per_call=art_launches,
                                 max_abs_vs_live=diff, scale=scale, bit_exact=diff == 0.0,
                                 cli_separate=dict(files=len(files), seconds=sep_s, launches=sep_launches))
    log(f"[options] set C: cli.export_model --batch {SERVE_BATCH} --len-s {SERVE_SECONDS} -N {ART_N} ddim: "
        f"{export_s:.1f} s, {art.stat().st_size / 1e6:.1f} MB; a call {SERVE_BATCH / call_s:.3f} utt/s; against "
        f"the live separate_masked {diff:.3g} of scale {scale:.3g}{' (bit for bit)' if diff == 0.0 else ''}; "
        f"cli.separate --model ARTIFACT: {len(files)} files in {sep_s:.1f} s, launches {sep_launches}")
    del sep
    torch.cuda.empty_cache()

    # e. the f32 fallback recipe (float32, remat) through cli.train.main at
    # the published 6 x 5 s
    steps = F32_WARMUP + F32_TIMED
    overrides = ["experiment=icassp-separation", f"path.datasets.wsj0_mix={data}", f"path.exp_root={tmp}/exp_f32",
                 f"trainer.max_steps={steps}", "model.valid_max_sep_batches=0", "trainer.deterministic=true",
                 "model.score_model.backbone_args.dtype=float32", "model.score_model.backbone_args.remat=true"]
    log(f"[options] python -m diffsep_tpu_torch.cli.train {' '.join(overrides)}")
    per_step = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    with mock.patch.object(DiffSepModel, "make_train_step", counting_train_step(per_step)):
        state = train_cli.main(overrides)
    torch.cuda.synchronize()
    total.update({k: v for k, v in _build.launch_counts.items() if v})
    run_dir = next(Path(tmp, "exp_f32").glob("*/*/train_log.jsonl")).parent
    assert state.step == steps and len(per_step) == steps, (state.step, len(per_step))
    speed, rows = train_speed(run_dir, F32_WARMUP, F32_TIMED, TRAIN_BATCH)
    want = {k: sum(v) for k, v in REMAT_PER_STEP.items()}
    want_bwd = {k: v[1] for k, v in REMAT_PER_STEP.items() if v[1]}
    for s in per_step:
        assert s["launches"] == want and s["backward"] == want_bwd, (s["launches"], s["backward"])
    losses = [r["train/score_loss"] for r in rows]
    assert all(np.isfinite(losses)), losses
    out["f32_remat_train"] = dict(overrides=overrides, **speed, peak_gib=max(s["peak_gib"] for s in per_step),
                                  losses=losses, launches_per_micro_step=per_step[-1]["launches"],
                                  backward_per_micro_step=per_step[-1]["backward"])
    log(f"[options] f32 + remat, {steps} micro-steps of {per_step[0]['batch']}: {speed['ms_per_micro_step']:.2f} ms "
        f"per micro-step over the last {F32_TIMED}, {speed['samples_per_s']:.3f} samples/s, peak "
        f"{out['f32_remat_train']['peak_gib']:.2f} GiB ({card}); launches per micro-step {per_step[-1]['launches']}, "
        f"of them backward {per_step[-1]['backward']}; losses {losses}")

    # f. one micro-step's gradients with remat against without, and the
    # peak memory of each, on the run's weights (cuDNN deterministic)
    payload = load_payload(run_dir / "checkpoints" / "latest.pt")
    model = DiffSepModel(payload["config"], device=dev, seed=1)
    model.score_model.load_state_dict(payload["model"], strict=True)
    del payload
    b_rng = np.random.default_rng(6)
    draws = {"mask": np.array([0.05, 0.5, 0.5, 0.5, 0.5, 0.05], np.float32),
             "z0": b_rng.standard_normal((TRAIN_BATCH, 2, n), dtype=np.float32),
             "z": b_rng.standard_normal((TRAIN_BATCH, 2, n), dtype=np.float32),
             "shuffle": b_rng.uniform(size=(TRAIN_BATCH, 2)).astype(np.float32),
             "time": b_rng.uniform(size=TRAIN_BATCH).astype(np.float32)}
    tgt6 = torch.from_numpy(0.1 * b_rng.standard_normal((TRAIN_BATCH, 2, n), dtype=np.float32))
    mix6 = tgt6.sum(dim=1, keepdim=True)
    res, peaks, grad_shapes = {}, {}, {True: collections.Counter(), False: collections.Counter()}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (True, False):
            model.score_model.backbone.remat = remat
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_counts()
            with recording_kernels(grad_shapes[remat]):
                res[remat] = loss_and_grads(model, draws, mix6, tgt6)
            torch.cuda.synchronize()
            peaks[remat] = torch.cuda.max_memory_allocated() / 2**30
            if remat:
                bwd_shapes = collections.Counter(_build.backward_shapes)
    finally:
        torch.backends.cudnn.deterministic = prev
    gr, gn = res[True][1], res[False][1]
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in gn.values())).item()
    remat_err = max((gr[k] - gn[k]).abs().max().item() for k in gn) / norm
    n_new = hold(grad_shapes[True] + grad_shapes[False], "f32 + remat micro-step", per_step=grad_shapes[True])
    out["f32_remat_grad_check"] = dict(rel_err=remat_err, tol=REMAT_TOL, norm=norm, peak_gib_remat=peaks[True],
                                       peak_gib_no_remat=peaks[False], losses=[res[True][0], res[False][0]],
                                       new_kernel_shapes=n_new)
    remat_rows = [r for r in checks if r["path"] == "f32 + remat micro-step"]
    out["f32_remat_conv_per_micro_step"] = f32 = f32_sums(remat_rows, "launches_per_micro_step")
    log(f"[options] f32 + remat micro-step at {TRAIN_BATCH} x {SERVE_SECONDS} s, float32 conv3x3 forward "
        f"({f32['launches']} launches; the split passes run once per call in grad mode): {f32_text(f32)} ({card})")
    log(f"[options] f32 micro-step at {TRAIN_BATCH} x {SERVE_SECONDS} s: gradients with remat vs without "
        f"{remat_err:.3g} of their norm {norm:.4g} (tol {REMAT_TOL}); peak {peaks[True]:.2f} GiB with remat, "
        f"{peaks[False]:.2f} without ({card}); {n_new} new kernel shapes held")
    assert remat_err <= REMAT_TOL and peaks[True] < peaks[False], (remat_err, peaks)
    del res, gr, gn
    torch.cuda.empty_cache()

    # the micro-step's dx and dw at each of its f32 conv shapes: held to the
    # plain versions, timed beside cuDNN's backward, summed per micro-step
    bwd_rows = []
    for (kind, shape, cout), n_dw in sorted(bwd_shapes.items()):
        if kind != "conv3x3_dw":
            continue
        rows = check_conv_bwd(shape, cout, dev, 400 + len(bwd_rows), cycles_per_ms)
        rows[0]["launches_per_micro_step"] = bwd_shapes.get(("conv3x3", (*shape[:3], cout), shape[3]), 0)
        rows[1]["launches_per_micro_step"] = n_dw
        for r in rows:
            log(f"[options-bwd] f32 + remat micro-step: {r['part']} of {list(shape)}->{cout} "
                f"x{r['launches_per_micro_step']}:{plan_text(r['plan'])} err {r['rel_err']:.3g} of max |plain| "
                f"(tol {BWD_TOL}) ms {r['ms']:.4f} plain {r['plain_ms']:.4f} cuDNN {r['library_ms']:.4f} bound "
                f"{r['bound_ms']:.4f} ({r['bound_by']}; FFMA {r['bound_ffma_ms']:.4f}, 3xTF32 "
                f"{r['bound_3xtf32_ms']:.4f})")
        bwd_rows += rows
    out["f32_remat_backward_checks"] = bwd_rows
    out["f32_remat_backward_per_micro_step"] = bsum = bwd_sums(bwd_rows)
    for part, v in bsum.items():
        plans = ", ".join(f"{k} {x:.3f}" for k, x in sorted(v["ms_by_plan"].items()))
        groups = "; ".join(f"{k} x{g['launches']}: hand {g['ms']:.3f}, cuDNN {g['library_ms']:.3f}, bound "
                           f"{g['bound_ms']:.3f}" for k, g in sorted(v["by_group"].items()))
        log(f"[options] f32 + remat micro-step at {TRAIN_BATCH} x {SERVE_SECONDS} s, {part} ({v['launches']} "
            f"launches): hand {v['ms']:.3f} ms ({plans}), "
            f"plain {v['plain_ms']:.3f}, cuDNN deterministic {v['library_ms']:.3f}, bound {v['bound_ms']:.3f} by "
            f"plan ({v['bound_by']}; {v['bound_ffma_ms']:.3f} all at the FFMA peak, {v['bound_3xtf32_ms']:.3f} all as "
            f"3 TF32 products); largest error {v['max_rel_err']:.3g} of "
            f"max |plain|; by group: {groups} ({card})")
    assert (bsum["dx"]["launches"], bsum["dw"]["launches"]) == (REMAT_PER_STEP["conv3x3"][1],
                                                                REMAT_PER_STEP["conv3x3_dw"][1]), bsum
    assert all(r["ok"] for r in bwd_rows), [r for r in bwd_rows if not r["ok"]]

    # where a micro-step's device time goes with remat: one loss and its
    # backward under torch.profiler (cuDNN deterministic, as the run)
    sm = model.score_model
    sm.backbone.remat = True
    loss_fn = make_loss_fn(sm, model.sde, model.loss_cfg)
    t_draws = {k: torch.from_numpy(v).to(dev) for k, v in draws.items()}
    mix6, tgt6 = mix6.to(dev), tgt6.to(dev)

    def micro_step():
        sm.zero_grad(set_to_none=True)
        loss_fn(Draws(None, t_draws), mix6, tgt6).backward()

    torch.backends.cudnn.deterministic = True
    try:
        prof = busy_and_host_ms(micro_step, 1)
    finally:
        torch.backends.cudnn.deterministic = prev
    out["f32_remat_profile"] = prof
    log(f"[options] f32 + remat micro-step at {TRAIN_BATCH} x {SERVE_SECONDS} s: {busy_text(prof)} ({card}); "
        f"framework conv calls {prof['framework_conv_calls']}")
    for k in prof["top_kernels"]:
        log(f"[options]   {k['ms']:9.3f} ms {k['launches']:6.0f} x  {k['name']}")
    assert not prof["framework_conv_calls"].get("aten::convolution_backward"), prof["framework_conv_calls"]
    assert prof["device_ms_by_group"]["cuDNN convs"] == 0, prof["top_kernels"]
    del model, sm
    torch.cuda.empty_cache()

    # g. blockwise attention: the flagship scores one 1 x 70 s mixture
    # (4416 tokens at the attention level), blockwise and naive, in bf16 and
    # in float32 on the same weights
    ln = LONG_SECONDS * FS
    l_rng = np.random.default_rng(61)
    lx = torch.from_numpy((0.3 * l_rng.standard_normal((1, 2, ln))).astype(np.float32)).to(dev)
    lm = torch.from_numpy((0.3 * l_rng.standard_normal((1, 1, ln))).astype(np.float32)).to(dev)
    lt = torch.tensor([0.5], device=dev)
    blockwise_calls = collections.Counter()
    real_blockwise = layers.blockwise_attention

    def counting_blockwise(q, *args, **kwargs):
        blockwise_calls[q.shape[1]] += 1
        return real_blockwise(q, *args, **kwargs)

    long, scores = {}, {}
    for dtype_name in ("bfloat16", "float32"):
        model = randomized_model({"score_model": {"backbone_args": {"dtype": dtype_name}}}, dev, 60)
        for label, flag in (("blockwise", ""), ("naive", "0")):  # "": chosen by the token count
            with mock.patch.dict(os.environ, {"DIFFSEP_ATTN_BLOCKWISE": flag}), \
                    mock.patch.object(layers, "blockwise_attention", counting_blockwise):

                def evaluate():
                    with torch.no_grad():
                        return model.score_fn(lx, lt, lm)

                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                blockwise_calls.clear()
                _build.reset_counts()
                scores[dtype_name, label] = evaluate()
                got = counted(f"70 s {dtype_name} {label}", PER_EVAL)
                row = dict(blockwise_calls=dict(blockwise_calls), launches=got,
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30)
                if dtype_name == "bfloat16":
                    row.update(busy_and_host_ms(evaluate, 2))
                _build.reset_counts()
            assert torch.isfinite(scores[dtype_name, label]).all(), (dtype_name, label)
            assert row["blockwise_calls"] == ({4416: 3} if label == "blockwise" else {}), row["blockwise_calls"]
            long[f"{dtype_name} {label}"] = row
        del model
    ref = scores["float32", "naive"]
    scale = ref.abs().max().item()

    def rel(key):
        return (scores[key] - ref).abs().max().item() / scale

    errs = {"float32 blockwise vs naive": rel(("float32", "blockwise")),
            "bfloat16 blockwise vs float32 naive": rel(("bfloat16", "blockwise")),
            "bfloat16 naive vs float32 naive": rel(("bfloat16", "naive")),
            "bfloat16 blockwise vs bfloat16 naive":
                (scores["bfloat16", "blockwise"] - scores["bfloat16", "naive"]).abs().max().item() / scale}
    out["long_attention"] = dict(seconds=LONG_SECONDS, tokens=4416, rel_err=errs, tol=LONG_TOL, scale=scale, **long)
    for label in ("blockwise", "naive"):
        r = long[f"bfloat16 {label}"]
        log(f"[options] flagship bf16, 1 x {LONG_SECONDS} s (4416 tokens at the attention level), {label}: "
            f"{busy_text(r)}, peak {r['peak_gib']:.2f} GiB ({card}); f32 peak {long[f'float32 {label}']['peak_gib']:.2f}")
    log(f"[options] 70 s scores, of the f32 naive one's scale {scale:.3g}: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    # blockwise is exact up to the reassociation of its tile sums; in bf16
    # it rounds unnormalized probabilities where naive rounds normalized
    # ones, so it is held to be no further from f32 than the naive path is
    assert errs["float32 blockwise vs naive"] <= LONG_TOL, errs
    assert errs["bfloat16 blockwise vs float32 naive"] <= 2 * errs["bfloat16 naive vs float32 naive"], errs
    del scores, ref
    torch.cuda.empty_cache()

    bad = [r for r in checks if not r["ok"]]
    out["kernel_checks"] = checks
    out["launches"] = dict(total)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[options] {len(checks)} new kernel shapes held; phase 12 took {out['seconds']:.1f} s; launches {dict(total)}")
    assert not bad, f"kernel mismatches at phase 12's shapes: {bad}"
    return out, collections.Counter(total)


# --- phase 13: FSDP, tensor parallelism, three speakers, the tools ---------
def _state_bytes(state):
    """Bytes this rank holds of a train state: parameters, optimizer (Adam's
    moments and the accumulator), EMA."""
    opt = state.optimizer

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    return dict(params=nbytes(state.params), optimizer=nbytes([*opt.mu, *opt.nu, *(opt.acc or [])]),
                ema=nbytes(state.ema.params))


@contextlib.contextmanager
def rank_group(rank, world, init_method, backend, card_index):
    """This process as rank ``rank`` of ``world`` on card ``card_index``,
    TF32 off; yields the card and destroys the process group after."""
    import torch
    import torch.distributed as dist

    from diffsep_tpu_torch.utils.distributed import initialize_distributed

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(backend=backend, device_type="cuda", rank=rank, world_size=world,
                           init_method=init_method, device_index=card_index)
    try:
        yield torch.device("cuda", card_index)
    finally:
        dist.destroy_process_group()


def fsdp_worker(rank, world, init_method, backend, card_index, base, exp_root, out_dir):
    """One rank of phase 13's FSDP check (a process of its own); see
    ``fsdp_fits``."""
    with rank_group(rank, world, init_method, backend, card_index) as dev:
        fsdp_fits(rank, dev, base, exp_root, out_dir)


def fsdp_tp_worker(rank, world, init_method, backend, card_index, base, exp_root, out_dir, seed):
    """One rank of phase 13's FSDP and tensor-parallel checks, one process
    for both: ``fsdp_fits``, then ``tp_runs``."""
    with rank_group(rank, world, init_method, backend, card_index) as dev:
        fsdp_fits(rank, dev, base, exp_root, out_dir)
        tp_runs(rank, world, dev, seed, out_dir)


def fsdp_fits(rank, dev, base, exp_root, out_dir):
    """The recipe through ``cli.train.train`` with trainer.strategy ddp, then
    fsdp, on the same rows, on this rank of the process group; per fit the
    launches per micro-step, the bytes this rank holds and its peak; for
    fsdp, each validation's metrics and, on rank 0, the last one again with
    the gathered one-process model. Writes <strategy>_rank<r>.json and, on
    rank 0, <strategy>_params.pt (the whole parameters after the fit)."""
    import torch
    import torch.distributed as dist

    from diffsep_tpu_torch.cli import train as train_cli
    from diffsep_tpu_torch.config import compose
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.ops import _build
    from diffsep_tpu_torch.train import loop

    validate = loop.validate
    for strategy in ("ddp", "fsdp"):
        per_step, held, vals = [], {}, []
        counted = counting_train_step(per_step)

        def make_step(self, seed, forward=None):
            run = counted(self, seed, forward=forward)

            def step(state, *args, **kwargs):
                held.setdefault("bytes", _state_bytes(state))
                return run(state, *args, **kwargs)

            return step

        def recorded_validate(model, datamodule, state, val_loss_fn, sep_seed):
            out = validate(model, datamodule, state, val_loss_fn, sep_seed)
            vals.append(out)
            held.update(model=model, datamodule=datamodule, sep_seed=sep_seed)
            return out

        ov = [*base, f"trainer.strategy={strategy}", f"path.exp_root={exp_root}/{strategy}"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        with mock.patch.object(DiffSepModel, "make_train_step", make_step), \
                mock.patch.object(loop, "validate", recorded_validate):
            state = train_cli.train(compose(ov), ov, str(dev))
        torch.cuda.synchronize()
        report = dict(rank=rank, strategy=strategy, step=state.step, bytes=held["bytes"], validations=vals,
                      launches=dict(_build.launch_counts),
                      shapes=[[k, list(shape), cout] for k, shape, cout in _build.launch_shapes],
                      per_step=[dict(launches=s["launches"], backward=s["backward"], batch=s["batch"])
                                for s in per_step],
                      peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        if rank == 0:
            model = held["model"]  # the one-process model fit handed back
            torch.save({k: v.detach().cpu() for k, v in zip(state.names, state.params)},
                       Path(out_dir) / f"{strategy}_params.pt")
            if strategy == "fsdp":
                # fit's validation loss draws from seed + 1
                val_loss = model.make_val_loss(int(compose(ov).get("seed", 0)) + 1)
                report["gathered_validation"] = validate(model, held["datamodule"], state, val_loss,
                                                         held["sep_seed"])
        Path(out_dir, f"{strategy}_rank{rank}.json").write_text(json.dumps(report))
        dist.barrier()


def tp_worker(rank, world, init_method, backend, card_index, seed, out_dir, dp=1):
    """One rank of phase 13's tensor-parallel check (a process of its own);
    see ``tp_runs``."""
    with rank_group(rank, world, init_method, backend, card_index) as dev:
        tp_runs(rank, world, dev, seed, out_dir, dp)


def tp_runs(rank, world, dev, seed, out_dir, dp=1):
    """The tensor-parallel check on this rank of the process group: the
    flagship (seeded, the same weights on every rank) separates ``dp`` 5 s
    mixtures (one per dp group) with ddim + none at TP_N, replicated on rank
    0 alone, then over a (dp, world / dp) layout (``make_tp_separate``)
    twice, the second timed; writes the estimates, launches, kernel shapes,
    times and peak to tp_rank<r>.pt."""
    import torch

    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.ops import _build
    from diffsep_tpu_torch.parallel import mesh
    from diffsep_tpu_torch.parallel.tensor_parallel import make_tp_separate

    kw = dict(predictor_name="ddim", corrector_name="none", N=TP_N)
    model = DiffSepModel(device=dev, seed=0)
    mix = torch.from_numpy(np.random.default_rng(seed).standard_normal((dp, 1, SERVE_SECONDS * FS))
                           .astype(np.float32) * 0.1)
    out = {}
    if rank == 0:
        for _ in range(2):  # the second timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if dp == 1:
                ref, _ = model.separate(mix, generator=torch.Generator(device=dev).manual_seed(seed), **kw)
            else:  # the whole batch's draws, as make_tp_separate draws them
                from diffsep_tpu_torch.parallel.tensor_parallel import _draw_noise

                noise = _draw_noise(model, dp, mix.shape[-1], torch.Generator(device=dev).manual_seed(seed),
                                    model._sampler_kwargs(kw))
                ref, _ = model.separate(mix, noise=noise, **kw)
            torch.cuda.synchronize()
            out["replicated_s"] = time.perf_counter() - t0
        out["replicated"] = ref.cpu()
    mesh.barrier()
    run = make_tp_separate(model, dp=dp, tp=world // dp, **kw)
    out["weight_bytes"] = sum(p.numel() * p.element_size() for p in model.score_model.parameters())
    torch.cuda.reset_peak_memory_stats()
    for i in range(2):
        mesh.barrier()
        _build.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est, nfe = run(torch.Generator(device=dev).manual_seed(seed), mix)
        torch.cuda.synchronize()
        out[f"tp_s_{i}"] = time.perf_counter() - t0
    out.update(est=est.cpu(), nfe=nfe, launches=dict(_build.launch_counts),
               shapes=[[k, list(s), c, n] for (k, s, c), n in _build.launch_shapes.items()],
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    torch.save(out, Path(out_dir) / f"tp_rank{rank}.pt")


def slice12_phase(dev, card, cycles_per_ms, tmp, run_dir, data, checked):
    """Phase 13: FSDP training, tensor-parallel separation, three speakers,
    and the tools (evaluate_covl, merge_dnsmos, export_model --torch and
    --avg-last-k); see the module docstring. ``run_dir`` and ``data`` are
    phase 6's run dir and folder, ``checked`` the (kernel, shape, cout) keys
    earlier phases held in bf16. Returns (report, launches over the phase's
    main-path runs)."""
    import torch

    from diffsep_tpu_torch.cli import evaluate as eval_cli
    from diffsep_tpu_torch.cli import evaluate_covl, export_model, merge_dnsmos
    from diffsep_tpu_torch.cli.loading import load_model, read_checkpoint
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.ops import _build

    out, total, new_shapes = {}, collections.Counter(), collections.Counter()
    t_phase = time.perf_counter()
    cards = [0, 1] if torch.cuda.device_count() >= 2 else [0, 0]
    backend = "nccl" if len(set(cards)) == 2 else "gloo"
    out["backend"], out["cards"] = backend, cards

    # 1. FSDP against DDP: the recipe on 2 ranks, the same rows
    base = ["experiment=icassp-separation", f"path.datasets.wsj0_mix={data}", f"trainer.max_steps={FSDP_STEPS}",
            "trainer.check_val_every_n_epoch=1", f"datamodule.train.dl_opts.batch_size={FSDP_BATCH}",
            "model.valid_max_sep_batches=1", f"model.sampler.N={FSDP_VAL_N}"]
    log(f"[fsdp] 2 ranks on cards {cards} ({backend}): cli.train.train {' '.join(base)} with "
        f"trainer.strategy=ddp, then fsdp; then, in the same processes, the tensor-parallel separation (2.)")
    rep_dir = Path(tmp) / "fsdp_reports"
    rep_dir.mkdir()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    run_ranks(fsdp_tp_worker, lambda r: (r, 2, init_method, backend, cards[r], base, f"{tmp}/exp_fsdp", str(rep_dir),
                                         31), 2, 600)
    out["fsdp_tp_ranks_s"] = time.perf_counter() - t0
    rep = {s: [json.loads((rep_dir / f"{s}_rank{r}.json").read_text()) for r in range(2)] for s in ("ddp", "fsdp")}
    runs = {s: next(Path(tmp, "exp_fsdp", s).glob("*/*/train_log.jsonl")).parent for s in ("ddp", "fsdp")}
    losses = {s: [r["train/score_loss"] for r in train_speed(runs[s], 1, FSDP_STEPS - 1, 2 * FSDP_BATCH)[1]]
              for s in runs}
    params = {s: torch.load(rep_dir / f"{s}_params.pt") for s in runs}
    keys = sorted(params["ddp"])
    param_err = rel_err([params["fsdp"][k] for k in keys], [params["ddp"][k] for k in keys])
    loss_err = max(abs(f - d) / abs(d) for f, d in zip(losses["fsdp"], losses["ddp"]))
    gathered, last = rep["fsdp"][0]["gathered_validation"], rep["fsdp"][0]["validations"][-1]
    val_err = max(abs(gathered[k] - last[k]) / max(abs(last[k]), 1e-12) for k in last)
    want = {k: sum(v) for k, v in TRAIN_PER_STEP.items()}
    want_bwd = {k: v[1] for k, v in TRAIN_PER_STEP.items() if v[1]}
    for s in rep:
        for r in rep[s]:
            total.update(r["launches"])
            new_shapes.update({(k, tuple(shape), cout): 1 for k, shape, cout in r["shapes"]})
    out["fsdp"] = dict(
        losses=losses, loss_rel_err=loss_err, param_rel_err=param_err, tol=FSDP_TOL,
        bytes_per_rank={s: [r["bytes"] for r in rep[s]] for s in rep},
        peak_gib_per_rank={s: [r["peak_gib"] for r in rep[s]] for s in rep},
        validations=rep["fsdp"][0]["validations"], gathered_validation=gathered, validation_rel_err=val_err,
        per_rank_micro_step=rep["fsdp"][0]["per_step"][-1])
    for s in ("ddp", "fsdp"):
        b = [r["bytes"] for r in rep[s]]
        log(f"[fsdp] {s}: losses {losses[s]}; per rank parameters {[x['params'] / 2**20 for x in b]} MiB, "
            f"optimizer {[x['optimizer'] / 2**20 for x in b]} MiB, EMA {[x['ema'] / 2**20 for x in b]} MiB, "
            f"peak {[round(r['peak_gib'], 3) for r in rep[s]]} GiB ({card})")
    log(f"[fsdp] fsdp vs ddp on the same rows: losses {loss_err:.3g} relative (tol {FSDP_TOL['loss']:g}), "
        f"parameters after {FSDP_STEPS} micro-steps {param_err:.3g} of their norm (tol {FSDP_TOL['params']:g}); "
        f"validation {last} against the gathered one-process model's {gathered}: {val_err:.3g} relative")
    for s in rep:
        for r in rep[s]:
            assert r["step"] == FSDP_STEPS and len(r["per_step"]) == FSDP_STEPS, (s, r["step"])
            assert all(p["launches"] == want and p["backward"] == want_bwd and p["batch"][0] == FSDP_BATCH
                       for p in r["per_step"]), (s, r["per_step"])
    assert all(np.isfinite(losses[s]).all() for s in losses), losses
    assert loss_err <= FSDP_TOL["loss"] and param_err <= FSDP_TOL["params"], (loss_err, param_err)
    assert val_err <= FSDP_TOL["validation"], (last, gathered)
    assert len(rep["fsdp"][0]["validations"]) == 2, rep["fsdp"][0]["validations"]  # one per epoch
    assert all(rep["fsdp"][r]["bytes"]["optimizer"] < rep["ddp"][r]["bytes"]["optimizer"] for r in range(2))
    # the FSDP checkpoint separates a mixture in one process
    _build.reset_counts()
    model = load_model(runs["fsdp"], device=dev)
    mix1 = torch.from_numpy(np.random.default_rng(30).standard_normal((1, 1, SERVE_SECONDS * FS))
                            .astype(np.float32) * 0.1)
    est, nfe = model.separate(mix1, generator=torch.Generator(device=dev).manual_seed(0), predictor_name="ddim",
                              corrector_name="none", N=TP_N)
    torch.cuda.synchronize()
    got = dict(_build.launch_counts)
    total.update(got)
    assert est.shape == (1, 2, SERVE_SECONDS * FS) and torch.isfinite(est).all() and got == launches_of(nfe), got
    log(f"[fsdp] the fsdp run's checkpoint separates a {SERVE_SECONDS} s mixture in one process, ddim N={TP_N}, "
        f"finite; launches {got}")
    del model

    # 2. tensor-parallel separation at tp=2 against the replicated one, run
    # by the ranks of 1. after their fits
    log(f"[tp] flagship, one {SERVE_SECONDS} s mixture, ddim + none N={TP_N}: tp=2 over 2 ranks on cards {cards} "
        f"({backend}) against the replicated separation of the same seed")
    tps = [torch.load(rep_dir / f"tp_rank{r}.pt", weights_only=False) for r in range(2)]
    ref = tps[0]["replicated"]
    scale = ref.abs().max().item()
    tp_err = max((t["est"] - ref).abs().max().item() for t in tps) / scale
    tp_shapes = collections.Counter()
    for t in tps:
        total.update(t["launches"])
        for k, shape, cout, cnt in t["shapes"]:
            tp_shapes[(k, tuple(shape), cout)] += cnt
    out["tp"] = dict(rel_err=tp_err, tol=TP_TOL, nfe=tps[0]["nfe"], replicated_s=tps[0]["replicated_s"],
                     tp_s=[t["tp_s_1"] for t in tps], tp_first_s=[t["tp_s_0"] for t in tps],
                     launches_per_rank=[t["launches"] for t in tps], peak_gib=[t["peak_gib"] for t in tps],
                     weight_mib_per_rank=[t["weight_bytes"] / 2**20 for t in tps])
    log(f"[tp] tp=2 vs replicated: {tp_err:.3g} of scale {scale:.3g} (tol {TP_TOL:g}); seconds per utterance "
        f"replicated {tps[0]['replicated_s']:.3f}, tp=2 {[round(t['tp_s_1'], 3) for t in tps]} (first call "
        f"{[round(t['tp_s_0'], 3) for t in tps]}); weights per rank {out['tp']['weight_mib_per_rank']} MiB; peak "
        f"{[round(t['peak_gib'], 3) for t in tps]} GiB; launches per rank {tps[0]['launches']} ({card})")
    assert tp_err <= TP_TOL and all(torch.isfinite(t["est"]).all() for t in tps), tp_err
    assert all(t["launches"] == launches_of(t["nfe"]) for t in tps), [t["launches"] for t in tps]

    # 3. three speakers at full width: one evaluation and a ddim separation
    model3 = DiffSepModel({"n_speakers": 3}, device=dev, seed=0)
    n = SERVE_SECONDS * FS
    rng = np.random.default_rng(32)
    mix3 = torch.from_numpy((0.1 * rng.standard_normal((SERVE_BATCH, 1, n))).astype(np.float32)).to(dev)
    xt3 = torch.from_numpy((0.1 * rng.standard_normal((SERVE_BATCH, 3, n))).astype(np.float32)).to(dev)
    _build.reset_counts()
    with torch.no_grad():
        score3 = model3.score_fn(xt3, torch.full((SERVE_BATCH,), 0.5, device=dev), mix3)
    torch.cuda.synchronize()
    eval3 = dict(_build.launch_counts)
    spk_shapes = collections.Counter(_build.launch_shapes)
    _build.reset_counts()
    t0 = time.perf_counter()
    est3, nfe3 = model3.separate(mix3, generator=torch.Generator(device=dev).manual_seed(0), predictor_name="ddim",
                                 corrector_name="none", N=TP_N)
    torch.cuda.synchronize()
    secs3 = time.perf_counter() - t0
    sep3 = dict(_build.launch_counts)
    total.update(eval3)
    total.update(sep3)
    out["three_speakers"] = dict(launches_per_eval=eval3, separate_launches=sep3, separate_s=secs3)
    log(f"[3spk] n_speakers=3 flagship: one evaluation {eval3}; ddim N={TP_N} on {SERVE_BATCH} x {SERVE_SECONDS} s "
        f"in {secs3:.2f} s, output {tuple(est3.shape)}, launches {sep3}")
    assert score3.shape == (SERVE_BATCH, 3, n) and torch.isfinite(score3).all()
    assert est3.shape == (SERVE_BATCH, 3, n) and torch.isfinite(est3).all()
    assert eval3 == PER_EVAL and sep3 == launches_of(nfe3), (eval3, sep3)
    # the stem takes 2 x 3 + 2 channels, and the output pyramid's convs give
    # as many (6 and 6 at two speakers); the 1 x 1 output layer gives 6
    assert any(k == "conv3x3" and s[-1] == 8 for k, s, _ in spk_shapes) and \
        any(k == "conv3x3" and c == 8 for k, _, c in spk_shapes), sorted(spk_shapes, key=str)
    del model3

    # every new kernel shape of tp and three speakers, timed; of FSDP's, untimed
    checks = []
    for path, shapes_, timed in (("tp=2", tp_shapes, True), ("three speakers", spk_shapes, True),
                                 ("fsdp", new_shapes, False)):
        for i, key in enumerate(sorted(set(shapes_) - checked, key=str)):
            k, shape, cout = key
            r = check_kernel(k, shape, cout, "bfloat16", dev, 1300 + len(checks), cycles_per_ms if timed else None,
                             timed=timed)
            per_eval = {"tp=2": 2 * tps[0]["nfe"], "three speakers": 1}.get(path)
            r.update(path=path, launches_per_eval=shapes_[key] // per_eval if per_eval else None)
            checks.append(r)
            checked.add(key)
            timing = (f"ms {r['ms']:.4f} plain {r['plain_ms']:.4f} lib {r['library_ms']:.4f} bound "
                      f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})" if timed else "untimed")
            log(f"[slice12-kernel] {path}: {k} {shape}->{cout} bf16:{plan_text(r['plan'])} err "
                f"{r['max_abs_err']:.3g} (tol {r['tol']:.3g}) {timing}")
    out["kernel_checks"] = checks
    bad = [r for r in checks if not r["ok"]]
    assert not bad, f"kernel mismatches at phase 13's shapes: {bad}"
    out["tp_kernel_ms_per_eval"] = {
        k: sum(r["ms"] * r["launches_per_eval"] for r in checks if r["path"] == "tp=2" and r["kernel"] == k)
        for k in PER_EVAL}
    log(f"[tp] the hand kernels' time per evaluation on one rank at tp=2, over its shapes that no earlier phase "
        f"ran: {out['tp_kernel_ms_per_eval']} ms")

    # 4. the tools: cli.evaluate --save-n on phase 8's enhancement run, then
    # cli.evaluate_covl on its wavs and cli.merge_dnsmos with a CSV
    nr_run = next(Path(tmp, "exp_nr").glob("*/*/train_log.jsonl")).parent
    eval_out = Path(tmp) / "eval_covl"
    _build.reset_counts()
    eval_cli.main([str(nr_run), "--enhance", "--test", "--save-n", str(TOOLS_SAVE_N), "-N", str(TP_N),
                   "-o", str(eval_out)])
    torch.cuda.synchronize()
    (res_dir,) = eval_out.iterdir()
    records = json.loads((res_dir / "test.json").read_text())
    got = dict(_build.launch_counts)
    total.update(got)
    assert got == launches_of(sum(r["nfe"] for r in records)), got
    wav_dir = res_dir / "wav" / "test"
    evaluate_covl.main([str(wav_dir), str(wav_dir), "--sr", str(ENH_FS)])
    covl = json.loads((res_dir / "test_covl.json").read_text())
    covl_summary = json.loads((res_dir / "test_summary_covl.json").read_text())
    assert len(covl) == TOOLS_SAVE_N and all(np.isfinite(v).all() for e in covl.values() for v in e.values()), covl
    csv_rng = np.random.default_rng(33)
    with open(res_dir / "test_dnsmos.csv", "w") as f:
        f.write(",filename,len_in_sec,sr,num_hops,OVRL_raw,SIG_raw,BAK_raw,OVRL,SIG,BAK\n")
        for i, r in enumerate(records):
            vals = ",".join(f"{v:.3f}" for v in 2.0 + 2.0 * csv_rng.uniform(size=6))
            f.write(f"{i},wav/test/{r['batch_idx']:04d}.enh0.wav,{r['len_s']},{ENH_FS},12,{vals}\n")
    merge_dnsmos.main([str(res_dir)])
    merged = json.loads((res_dir / "test_with_dnsmos.json").read_text())
    merged_summary = json.loads((res_dir / "test_summary_with_dnsmos.json").read_text())
    assert len(merged) == len(records) and all(np.isfinite(r["OVRL"]).all() for r in merged), merged[:1]
    assert {"OVRL", "SIG", "BAK", "si_sdr"} <= set(merged_summary), merged_summary
    out["tools"] = dict(covl_summary=covl_summary, dnsmos_summary=merged_summary, evaluate_launches=got)
    log(f"[tools] cli.evaluate --enhance --test --save-n {TOOLS_SAVE_N} -N {TP_N}, then cli.evaluate_covl on its "
        f"{len(covl)} saved pairs: {covl_summary}; cli.merge_dnsmos: {merged_summary}")

    # cli.export_model --torch on phase 6's run; --avg-last-k 2 on the fsdp
    # run, which has two checkpoints
    ckpt = Path(tmp) / "phase6.ckpt"
    export_model.main([str(run_dir), "-o", str(ckpt), "--torch"])
    _, _, ema = read_checkpoint(Path(run_dir) / "checkpoints" / "latest.pt")
    back = load_model(ckpt, device=dev).score_model.state_dict()
    blob = torch.load(ckpt, map_location="cpu", weights_only=False)
    assert all(torch.equal(back[k].cpu(), ema[k].cpu()) for k in ema) and back.keys() == ema.keys()
    assert blob["hyper_parameters"]["config"]["model"]["score_model"]["_target_"] == \
        "models.score_models.ScoreModelNCSNpp", blob["hyper_parameters"]["config"]["model"]["score_model"]
    avg = Path(tmp) / "fsdp_avg2.ckpt"
    export_model.main([str(runs["fsdp"]), "-o", str(avg), "--torch", "--avg-last-k", "2"])
    emas = [read_checkpoint(p)[2] for p in sorted((runs["fsdp"] / "checkpoints").glob("[0-9]*.pt"))[-2:]]
    mean = {k: ((emas[0][k].double() + emas[1][k].double()) / 2).float() for k in emas[0]}
    back_avg = load_model(avg, device=dev).score_model.state_dict()
    assert all(torch.equal(back_avg[k].cpu(), mean[k]) for k in mean)
    out["export"] = dict(torch_ckpt_mb=ckpt.stat().st_size / 1e6, avg_ckpt_mb=avg.stat().st_size / 1e6)
    log(f"[tools] cli.export_model RUN_DIR --torch: {out['export']['torch_ckpt_mb']:.1f} MB, read back by the "
        f"port's loader bit for bit (the EMA weights); --torch --avg-last-k 2 on the fsdp run: the mean of its two "
        f"checkpoints' EMA weights, bit for bit")
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = dict(total)
    log(f"[slice12] phase 13 took {out['seconds']:.1f} s; launches {dict(total)}")
    return out, dict(total)


def legacy_blocks(c, classes):
    """Phase 14's modules at width ``c`` with ``classes`` noise scales: every
    block of models/legacy_layers.py and every normalization variant, by
    name -> (make(), inputs kind); "x" takes (x,), "xy" (x, y), "pair" the
    MSF/Refine inputs ([x, x at half the grid and twice the width], y?,
    shape), "odd" x one row and column short, "half" x at half the grid,
    "temb" (x, time embedding)."""
    import torch.nn.functional as F

    from diffsep_tpu_torch.models import legacy_layers as L
    from diffsep_tpu_torch.models import normalization as N

    cin = N.ConditionalInstanceNorm2dPlus
    return {
        "InstanceNorm2dPlus": (lambda: N.InstanceNorm2dPlus(c), "x"),
        "ConditionalInstanceNorm2dPlus": (lambda: N.ConditionalInstanceNorm2dPlus(c, classes), "xy"),
        "VarianceNorm2d": (lambda: N.VarianceNorm2d(c), "x"),
        "ConditionalVarianceNorm2d": (lambda: N.ConditionalVarianceNorm2d(c, classes), "xy"),
        "ConditionalBatchNorm2d eval": (lambda: N.ConditionalBatchNorm2d(c, classes), "xy"),
        "ConditionalBatchNorm2d train": (lambda: N.ConditionalBatchNorm2d(c, classes), "xy"),
        "ConditionalInstanceNorm2d": (lambda: N.ConditionalInstanceNorm2d(c, classes), "xy"),
        "InstanceNorm2d": (lambda: N.InstanceNorm2d(c), "x"),
        "NoneNorm2d": (lambda: N.NoneNorm2d(c), "x"),
        "ConditionalNoneNorm2d": (lambda: N.ConditionalNoneNorm2d(c, classes), "xy"),
        "GroupNorm (get_normalization)": (lambda: N.get_normalization({"model": {"normalization": "GroupNorm"}})(c),
                                          "x"),
        "CRPBlock maxpool": (lambda: L.CRPBlock(c, 2), "x"),
        "CRPBlock avgpool": (lambda: L.CRPBlock(c, 2, maxpool=False), "x"),
        "CondCRPBlock": (lambda: L.CondCRPBlock(c, 2, classes, cin), "xy"),
        "RCUBlock": (lambda: L.RCUBlock(c, 2, 2), "x"),
        "CondRCUBlock": (lambda: L.CondRCUBlock(c, 2, 2, classes, cin), "xy"),
        "MSFBlock": (lambda: L.MSFBlock([c, 2 * c], c), "pair"),
        "CondMSFBlock": (lambda: L.CondMSFBlock([c, 2 * c], c, classes, cin), "pair y"),
        "RefineBlock": (lambda: L.RefineBlock([c, 2 * c], c), "pair"),
        "RefineBlock end": (lambda: L.RefineBlock([c], c, end=True), "single"),
        "CondRefineBlock": (lambda: L.CondRefineBlock([c, 2 * c], c, classes, cin), "pair y"),
        "CondRefineBlock end": (lambda: L.CondRefineBlock([c], c, classes, cin, end=True), "single y"),
        "ConvMeanPool": (lambda: L.ConvMeanPool(c, 2 * c), "x"),
        "ConvMeanPool adjust_padding": (lambda: L.ConvMeanPool(c, 2 * c, adjust_padding=True), "odd"),
        "MeanPoolConv": (lambda: L.MeanPoolConv(c, 2 * c), "x"),
        "UpsampleConv": (lambda: L.UpsampleConv(c, c), "half"),
        "ResidualBlock": (lambda: L.ResidualBlock(c, c), "x"),
        "ResidualBlock widen": (lambda: L.ResidualBlock(c, 2 * c), "x"),
        "ResidualBlock down": (lambda: L.ResidualBlock(c, 2 * c, resample="down"), "x"),
        "ResidualBlock dilation 2": (lambda: L.ResidualBlock(c, c, dilation=2), "x"),
        "ResidualBlock down dilation 2": (lambda: L.ResidualBlock(c, 2 * c, resample="down", dilation=2), "x"),
        "ResidualBlock InstanceNorm++": (lambda: L.ResidualBlock(c, c, normalization=N.InstanceNorm2dPlus), "x"),
        "ConditionalResidualBlock": (lambda: L.ConditionalResidualBlock(c, c, classes), "xy"),
        "ConditionalResidualBlock down": (lambda: L.ConditionalResidualBlock(c, 2 * c, classes, resample="down"),
                                          "xy"),
        "ConditionalResidualBlock dilation 2": (lambda: L.ConditionalResidualBlock(c, 2 * c, classes, dilation=2),
                                                "xy"),
        "ResnetBlockDDPM": (lambda: L.ResnetBlockDDPM(F.silu, c, 2 * c, temb_dim=4 * c), "temb"),
        "ResnetBlockDDPM conv_shortcut": (lambda: L.ResnetBlockDDPM(F.silu, c, 2 * c, conv_shortcut=True), "x"),
    }


def seeded_block(make, seed, train=False):
    """``make()`` on the CPU, its parameters drawn from a generator seeded
    with ``seed`` (``legacy_layers.reset_parameters``), then each moved by
    N(0, 1) / sqrt(fan-in) (a vector's by 0.1 N(0, 1)), so that init_scale=0
    layers and constant embedding columns count while activations keep
    their scale through a chain of convs, and the batch norms' running
    statistics drawn; in eval mode unless ``train``."""
    import torch

    from diffsep_tpu_torch.models import legacy_layers

    block = make()
    g = torch.Generator().manual_seed(seed)
    legacy_layers.reset_parameters(block, g)
    with torch.no_grad():
        for p in block.parameters():
            p.add_(torch.randn(p.shape, generator=g) * (0.1 if p.ndim < 2 else (p.numel() / p.shape[0]) ** -0.5))
        for name, buf in block.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.3 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    return block.train(train)


def legacy_inputs(kind, c, grid, classes, seed, dev):
    """The inputs of a ``legacy_blocks`` entry: batch LEGACY_BATCH of
    unit-variance float32 on ``grid`` (drawn on the CPU from ``seed``)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    b, (h, w) = LEGACY_BATCH, grid

    def x(hh=h, ww=w, cc=c):
        return torch.randn((b, hh, ww, cc), generator=g).to(dev)

    def y():
        return torch.randint(0, classes, (b,), generator=g).to(dev)

    def pair():
        return [x(), x(h // 2, w // 2, 2 * c)]

    return {"x": lambda: (x(),), "xy": lambda: (x(), y()), "odd": lambda: (x(h - 1, w - 1),),
            "half": lambda: (x(h // 2, w // 2),), "temb": lambda: (x(), torch.randn((b, 4 * c), generator=g).to(dev)),
            "pair": lambda: (pair(), (h, w)), "pair y": lambda: (pair(), y(), (h, w)),
            "single": lambda: ([x()], (h, w)), "single y": lambda: ([x()], y(), (h, w))}[kind]()


def kernel_convs(module):
    """The 3x3 stride-1 undilated convs of ``module``: each takes the hand
    kernel once per forward."""
    from diffsep_tpu_torch.models import layers

    return sum(1 for m in module.modules() if isinstance(m, layers.Conv) and m.weight.shape[-1] == 3
               and m.stride == 1 and getattr(m, "dilation", 1) == 1)


def legacy_phase(dev, card, cycles_per_ms, tmp, run_dir, data):
    """Phase 14: the legacy blocks at NCSNv2's width, the figures CLI's
    reverse_diffusion_example, the native WAV decoder, fused_act and
    get_score_fn; see the module docstring. ``run_dir`` and ``data`` are
    phase 6's. Returns (report, launches over the phase's main-path runs:
    one forward of each block and the figure's sampler)."""
    import torch
    import torch.nn.functional as F

    from diffsep_tpu_torch.cli import eval_common, figures
    from diffsep_tpu_torch.cli.loading import load_model
    from diffsep_tpu_torch.data import audio_io, native_io
    from diffsep_tpu_torch.data.loader import DataLoader
    from diffsep_tpu_torch.data.wsj0_mix import WSJ0_mix
    from diffsep_tpu_torch.models import layers, legacy_layers, score_utils
    from diffsep_tpu_torch.ops import _build, fused_act
    from diffsep_tpu_torch.ops.plain import plain_kernels
    from diffsep_tpu_torch.sde.ouve import OUVESDE, OUVPSDE
    from diffsep_tpu_torch.train.losses import normalize_batch

    out, total = {}, collections.Counter()
    t_phase = time.perf_counter()

    # 1. every block at ngf = LEGACY_NGF on the top grid, float32: its hand
    # conv launches, its output against the plain versions on the card, its
    # device time; then every conv shape held and timed alone
    c, grid, classes = LEGACY_NGF, LEGACY_GRID, LEGACY_CLASSES
    blocks, shapes = {}, collections.Counter()
    for i, (name, (make, kind)) in enumerate(legacy_blocks(c, classes).items()):
        block = seeded_block(make, 1400 + i, train=name.endswith("train")).to(dev)
        inputs = legacy_inputs(kind, c, grid, classes, 1400 + i, dev)
        want_convs = kernel_convs(block)
        with torch.no_grad():
            _build.reset_counts()
            got = block(*inputs)
            torch.cuda.synchronize()
            counts = dict(_build.launch_counts)
            shapes.update(_build.launch_shapes)
            total.update(counts)
            with plain_kernels():
                want = block(*inputs)
            scale = max(1.0, want.abs().max().item())
            err = (got - want).abs().max().item()
            ms = time_ms(lambda: block(*inputs), cycles_per_ms)
        assert counts == ({"conv3x3": want_convs} if want_convs else {}), (name, counts, want_convs)
        # each hand conv adds its own rounding (each is held to TOL alone below)
        assert torch.isfinite(got).all() and err <= TOL["float32"] * max(1, want_convs) * scale, (name, err, scale)
        blocks[name] = dict(shape=list(got.shape), conv3x3_launches=counts.get("conv3x3", 0),
                            kernels_vs_plain=err / scale, ms=ms)
        log(f"[legacy] {name} at {c} channels, {LEGACY_BATCH} x {grid[0]} x {grid[1]}, f32: conv3x3 launches "
            f"{blocks[name]['conv3x3_launches']} (its undilated 3x3 convs), kernels vs plain {err / scale:.3g} of "
            f"scale, {ms:.3f} ms ({card})")
        del block, inputs, got, want
    out["blocks"] = blocks
    checks = []
    for j, ((k, shape, cout), cnt) in enumerate(sorted(shapes.items(), key=str)):
        r = check_kernel(k, shape, cout, "float32", dev, 1450 + j, cycles_per_ms)
        r["launches_per_legacy_set"] = cnt
        checks.append(r)
        log(f"[legacy-kernel] {k} {shape}->{cout} f32 x{cnt}:{plan_text(r['plan'])} err {r['max_abs_err']:.3g} "
            f"(tol {r['tol']:.3g}) ms {r['ms']:.4f} plain {r['plain_ms']:.4f} lib {r['library_ms']:.4f}"
            f"{f32_lib_text(r)} bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")
    out["kernel_checks"] = checks
    assert not [r for r in checks if not r["ok"]], checks
    out["per_set"] = {key: sum(r[key] * r["launches_per_legacy_set"] for r in checks)
                      for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["per_set"]["launches"] = sum(shapes.values())
    out["per_set"]["blocks_ms"] = sum(b["ms"] for b in blocks.values())
    log(f"[legacy] the set of {len(blocks)} modules: conv3x3 {out['per_set']['launches']} launches, hand "
        f"{out['per_set']['ms']:.3f} ms, plain {out['per_set']['plain_ms']:.3f}, cuDNN {out['per_set']['library_ms']:.3f},"
        f" bound {out['per_set']['bound_ms']:.3f}; the blocks' device time {out['per_set']['blocks_ms']:.3f} ms "
        f"({card})")

    # 2. the same modules at LEGACY_SMALL, card against CPU
    sc, sgrid = LEGACY_SMALL
    small = {}
    for i, (name, (make, kind)) in enumerate(legacy_blocks(sc, classes).items()):
        cpu = seeded_block(make, 1500 + i, train=name.endswith("train"))
        gpu = seeded_block(make, 1500 + i, train=name.endswith("train")).to(dev)
        with torch.no_grad():
            want = cpu(*legacy_inputs(kind, sc, sgrid, classes, 1500 + i, "cpu"))
            got = gpu(*legacy_inputs(kind, sc, sgrid, classes, 1500 + i, dev)).cpu()
        scale = want.abs().max().item()
        small[name] = (got - want).abs().max().item() / scale
        assert small[name] <= LEGACY_CPU_TOL, (name, small[name])
    out["card_vs_cpu_small"] = small
    log(f"[legacy] at {sc} channels on {sgrid[0]} x {sgrid[1]}, card against CPU: largest "
        f"{max(small.values()):.3g} of scale ({max(small, key=small.get)}), tolerance {LEGACY_CPU_TOL}")

    # 3. figures reverse_diffusion_example on phase 6's run dir: the
    # flagship's PC sampler at N = FIG_N with intermediates
    captured = {}

    def capture(x, ims, target, out_dir, index):
        captured.update(x=x, ims=ims, target=target)

    argv = [str(run_dir), "--data", str(data), "--out", str(Path(tmp) / "figures"), "-N", str(FIG_N)]
    with mock.patch.object(eval_common, "save_fig", capture):
        torch.cuda.synchronize()
        _build.reset_counts()
        t0 = time.perf_counter()
        x, nfe, ims = figures.reverse_diffusion_example(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(_build.launch_counts)
    total.update(counts)
    n = captured["target"].shape[-1]
    assert captured["ims"].shape == (FIG_N, 2, 1, 2, n) and np.isfinite(captured["ims"]).all(), \
        captured["ims"].shape
    assert nfe == 2 * FIG_N and counts == {k: v * nfe for k, v in PER_EVAL.items()}, (nfe, counts)
    model = load_model(run_dir, device=dev)
    mix, _ = WSJ0_mix(data, 2, FS, "max", "val")[0]
    (mix, _), _, _ = normalize_batch(torch.from_numpy(mix)[None])
    plain_x, _ = model.get_pc_sampler("reverse_diffusion", "ald2", mix, generator=torch.Generator(dev).manual_seed(0),
                                      N=FIG_N, snr=0.5, corrector_steps=1)()
    assert torch.equal(plain_x, x), (plain_x - x).abs().max().item()
    out["reverse_diffusion_example"] = dict(seconds=secs, nfe=nfe, launches=counts, ims_shape=list(ims.shape))
    log(f"[figures] reverse_diffusion_example on phase 6's run dir, N={FIG_N}: {secs:.2f} s, intermediates "
        f"{tuple(ims.shape)} finite, sources bit for bit get_pc_sampler's, launches {counts} ({card})")
    del model

    # 4. the native WAV decoder, built here: bit for bit scipy over phase
    # 6's folder; the loader at the recipe's batch takes it; host ms per
    # batch against scipy's item by item
    t0 = time.perf_counter()
    lib = native_io.build()
    build_s = time.perf_counter() - t0
    files = sorted(Path(data).rglob("*.wav"))
    decoded = native_io.load_wav_batch(files)
    assert all(np.array_equal(d, audio_io.load_wav(f)[0]) for d, f in zip(decoded, files))
    ds = WSJ0_mix(data, 2, FS, "max", "train")
    before = native_io.batch_calls
    batches = list(DataLoader(ds, batch_size=TRAIN_BATCH, shuffle=True, seed=0, num_shards=1, prefetch=0))
    loader_calls = native_io.batch_calls - before
    assert loader_calls == len(batches) == len(ds) // TRAIN_BATCH, loader_calls
    rows = list(range(TRAIN_BATCH))

    def host_ms(fn, reps=7):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    native_ms = host_ms(lambda: ds.getitem_batch(rows))
    scipy_ms = host_ms(lambda: [ds[i] for i in rows])
    out["native_io"] = dict(library=lib.name, build_s=build_s, files=len(files), loader_batches=len(batches),
                            loader_batch_calls=loader_calls, native_ms_per_batch=native_ms,
                            scipy_ms_per_batch=scipy_ms)
    log(f"[native_io] {lib.name} built in {build_s:.2f} s; {len(files)} files decoded bit for bit as scipy; the "
        f"loader's {len(batches)} batches of {TRAIN_BATCH} rows x 3 files took the native path; host ms per batch "
        f"{native_ms:.3f} native, {scipy_ms:.3f} scipy item by item ({card})")

    # 5. fused_act and get_score_fn (OUVE, OUVP), card against CPU
    g = torch.Generator().manual_seed(1600)
    xa, bias = torch.randn((2, c, 64, 80), generator=g), torch.randn((c,), generator=g)
    want = fused_act.fused_leaky_relu(xa, bias)
    got = fused_act.fused_leaky_relu(xa.to(dev), bias.to(dev)).cpu()
    fused_err = (got - want).abs().max().item() / want.abs().max().item()
    assert fused_err <= 1e-6, fused_err
    def ddpm():
        return legacy_layers.ResnetBlockDDPM(F.silu, sc, temb_dim=4 * sc)

    block_cpu = seeded_block(ddpm, 1601)
    block_gpu = seeded_block(ddpm, 1601).to(dev)
    xs = torch.randn((2, sgrid[0], sgrid[1], sc), generator=g)
    ys = torch.randn(xs.shape, generator=g)
    ts = torch.tensor([0.3, 0.8])
    score_errs = {}
    for label, sde in (("ouve", OUVESDE(N=30)), ("ouvp", OUVPSDE(N=30))):
        for continuous in (True, False):
            res = {}
            for d, blk in (("cpu", block_cpu), (dev, block_gpu)):
                def model_fn(x, labels, blk=blk):
                    return blk(x, layers.get_timestep_embedding(labels, 4 * sc))

                with torch.no_grad():
                    res[str(d)] = score_utils.get_score_fn(sde, model_fn, continuous)(
                        xs.to(d), ts.to(d), ys.to(d)).cpu()
            want = res["cpu"]
            key = f"{label} {'continuous' if continuous else 'discrete'}"
            score_errs[key] = (res[str(dev)] - want).abs().max().item() / want.abs().max().item()
            assert score_errs[key] <= LEGACY_CPU_TOL, (key, score_errs[key])
    out["fused_act_card_vs_cpu"], out["score_fn_card_vs_cpu"] = fused_err, score_errs
    log(f"[legacy] fused_leaky_relu card vs CPU {fused_err:.3g} of scale; get_score_fn card vs CPU {score_errs}")
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = dict(total)
    log(f"[legacy] phase 14 took {out['seconds']:.1f} s; launches {dict(total)}")
    return out, dict(total)


def demo_script(name):
    """scripts/<name>.py, a learning demo of the port, as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parent / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def demo_phase(dev, card, cycles_per_ms):
    """Phase 15: the separation learning demo; see the module docstring.
    Returns (report, launches over the phase's main-path runs: the training
    steps and the evaluation)."""
    import torch

    from diffsep_tpu_torch.ops import _build

    demo = demo_script("torch_port_train_demo")
    out = {}
    t_phase = time.perf_counter()

    # 1. training, through the script's loop (which sets the counts to 0
    # before its first step)
    model = demo.build_model("bfloat16", False, dev, seed=0)
    torch.cuda.reset_peak_memory_stats()
    run = demo.train(model, 0, DEMO_STEPS, np.random.default_rng(0), log=lambda m: log(f"[demo] {m}"))
    counts, train_shapes = run["launches"], run["launch_shapes"]
    train_plans = {plan: n for (k, plan), n in _build.launch_plans.items() if k == "conv3x3"}
    want = {k: DEMO_STEPS * sum(v) for k, v in DEMO_PER_STEP.items()}
    want_bwd = {k: DEMO_STEPS * v[1] for k, v in DEMO_PER_STEP.items() if v[1]}
    assert counts == want, (counts, want)
    assert run["backward_launches"] == want_bwd, (run["backward_launches"], want_bwd)
    cumulative = [{}] + run["window_launches"]
    windows = [dict(collections.Counter(b) - collections.Counter(a)) for a, b in zip(cumulative, cumulative[1:])]
    assert all(w == {k: 100 * sum(v) for k, v in DEMO_PER_STEP.items()} for w in windows), windows
    losses = run["losses"]
    assert np.isfinite(losses).all()
    first, last = float(losses[:10].mean()), float(losses[200:300].mean())
    out.update(steps=DEMO_STEPS, s_per_step=run["s_per_step"], train_s=run["train_time_s"],
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, loss_first=run["loss_first"],
               loss_mean_steps_1_10=first, loss_mean_steps_201_300=last,
               loss_mean_every100=[float(losses[i:i + 100].mean()) for i in range(0, DEMO_STEPS, 100)],
               launches_per_step={k: v / DEMO_STEPS for k, v in counts.items()},
               backward_launches_per_step={k: v / DEMO_STEPS for k, v in run["backward_launches"].items()})
    log(f"[demo] {DEMO_STEPS} steps of 16 x 1 s: {run['s_per_step'] * 1e3:.2f} ms per step after the first, "
        f"peak {out['peak_mem_gib']:.2f} GiB; mean loss steps 1-10 {first:.4f}, 201-300 {last:.4f} "
        f"(bar {DEMO_LOSS_RATIO} x); launches per step {out['launches_per_step']}, backward "
        f"{out['backward_launches_per_step']}, the same in each window of 100 ({card})")
    assert last < DEMO_LOSS_RATIO * first, (first, last)
    # every conv reading 32 or 96 channels ran the "slice32" plan
    c32 = sum(n for (k, shape, _), n in train_shapes.items() if k == "conv3x3" and c32_channels(shape[3]))
    out["conv_launches_per_step_by_plan"] = {plan: n / DEMO_STEPS for plan, n in sorted(train_plans.items())}
    log(f"[demo] conv3x3 launches per step by plan: {out['conv_launches_per_step_by_plan']}")
    assert c32 and train_plans.get("slice32", 0) == c32, (train_plans, c32)

    # 2. the script's evaluation of the EMA weights on its held-out set
    mix_te, tgt_te = demo.make_batch(np.random.default_rng(demo.HELDOUT_SEED), demo.HELDOUT_BATCH, demo.SAMPLES)
    _build.reset_counts()
    t0 = time.perf_counter()
    metrics, nfe = demo.evaluate(model, run["state"], mix_te, tgt_te)
    torch.cuda.synchronize()
    out["eval_s"] = time.perf_counter() - t0
    eval_counts, eval_shapes = dict(_build.launch_counts), dict(_build.launch_shapes)
    assert eval_counts == {k: nfe * v[0] for k, v in DEMO_PER_STEP.items()}, (eval_counts, nfe)
    assert all(np.isfinite(v) for v in metrics.values()) and abs(metrics["si_sdr_mixture_floor_db"]) <= 0.01
    out.update(eval_metrics=metrics, eval_nfe=nfe)
    log(f"[demo] evaluation after {DEMO_STEPS} steps ({nfe} evaluations of 8 x 1 s, {out['eval_s']:.2f} s): "
        f"{metrics}")

    # 3. the distillation of scripts/torch_port_distill_demo.py from the EMA
    # weights, on its batch stream (a fresh batch every step), then each
    # student's ddim SI-SDR on the held-out set at its N
    dist_counts, dist_shapes, student_counts, student_shapes = distill_demo_run(
        dev, card, model, run["state"], demo, (mix_te, tgt_te), out)

    # 4. every kernel shape of these runs against its plain version, timed
    rows = []
    dist_steps = len(DEMO_DISTILL_STAGES) * DEMO_DISTILL_STEPS
    shapes = set(train_shapes) | set(eval_shapes) | set(dist_shapes) | set(student_shapes)
    for i, key in enumerate(sorted(shapes, key=str)):
        k, shape, cout = key
        r = check_kernel(k, shape, cout, "bfloat16", dev, 1500 + i, cycles_per_ms)
        r["launches_per_step"] = train_shapes.get(key, 0) / DEMO_STEPS
        r["launches_per_eval"] = eval_shapes.get(key, 0) / nfe
        r["launches_per_distill_step"] = dist_shapes.get(key, 0) / dist_steps
        rows.append(r)
        r["bound_share"] = r["bound_ms"] / r["ms"]
        log(f"[demo] {k} {shape}->{cout} x{r['launches_per_step']:g}/step x{r['launches_per_eval']:g}/eval:"
            f"{plan_text(r['plan'])} err {r['max_abs_err']:.3g} (tol {r['tol']:.3g}) ms {r['ms']:.4f} "
            f"plain {r['plain_ms']:.4f} lib {r['library_ms']:.4f} ms/lib {r['ms_per_library_ms']:.3g} "
            f"bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}, {100 * r['bound_share']:.1f}% of it)")
    out["kernel_checks"] = rows
    bad = [r for r in rows if not r["ok"]]
    assert not bad, f"kernel mismatches at the demo's shapes: {bad}"

    def per_step(sel):
        chosen = [r for r in rows if sel(r) and r["launches_per_step"]]
        return {key: sum(r[key] * r["launches_per_step"] for r in chosen)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}

    out["ms_per_step"] = {k: per_step(lambda r, k=k: r["kernel"] == k) for k in KERNELS}
    # by plan, and by shape: the stem (Cin 6) and the Cin 32 and 96 convs,
    # apart and together (the 20 launches that the generic kernel ran before "slice32")
    for plan in sorted({r["plan"]["variant"] for r in rows if r["kernel"] == "conv3x3"}):
        out["ms_per_step"][f"conv3x3 {plan} plan"] = per_step(
            lambda r, plan=plan: r["kernel"] == "conv3x3" and r["plan"]["variant"] == plan)
    for label, sel in (("conv3x3 at Cin 6 (the stem)", lambda c: c == 6),
                       ("conv3x3 at Cin 32 and 96", c32_channels),
                       ("conv3x3 at Cin 6, 32 and 96", lambda c: c == 6 or c32_channels(c))):
        out["ms_per_step"][label] = per_step(lambda r, sel=sel: r["kernel"] == "conv3x3" and sel(r["shape"][3]))
    out["ms_per_step"] = {k: v for k, v in out["ms_per_step"].items() if v["ms"]}  # plans the step ran
    for k, v in out["ms_per_step"].items():
        log(f"[demo] {k} per training step (forward and backward launches): {v['ms']:.4f} ms, plain "
            f"{v['plain_ms']:.4f}, cuDNN {v['library_ms']:.4f}, bound {v['bound_ms']:.4f} "
            f"({100 * v['bound_ms'] / v['ms']:.1f}% of it; {card})")
    total = collections.Counter(counts)
    for c in (eval_counts, dist_counts, student_counts):
        total.update(c)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[demo] {len(rows)} kernel shapes held ({len(shapes - set(train_shapes) - set(eval_shapes))} new to "
        f"the distillation); phase 15 took {out['seconds']:.1f} s; launches {dict(total)}")
    return out, dict(total)


def smoke_distill(model, state, batch_fn, stages, steps_per_stage, schedule, seed, per_step, eval_per_step, score):
    """A distill demo's distillation from the EMA weights of ``state``
    through ``progressive_distill`` on ``batch_fn`` (draws from ``seed``),
    asserting its launches per distill step (``per_step``: {kernel:
    (forward, backward)}); then
    each student scored by ``score(n)`` -> (SI-SDR dB, score evaluations),
    asserting N evaluations of ``eval_per_step``'s forward launches each
    and a finite score. Returns (report, launches and launch shapes of the
    distill steps, the same of the students' evaluations)."""
    import torch

    from diffsep_tpu_torch.ops import _build
    from diffsep_tpu_torch.train.distill import ema_state_dict, progressive_distill

    res = {"stages": list(stages), "steps_per_stage": steps_per_stage, "schedule": schedule}
    model.score_model.load_state_dict(ema_state_dict(model, state), strict=True)
    steps = len(stages) * steps_per_stage
    _build.reset_counts()
    t0 = time.perf_counter()
    students = progressive_distill(model, batch_fn, stages=stages, steps_per_stage=steps_per_stage,
                                   seed=seed, schedule=schedule)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    res["s_per_distill_step"] = (time.perf_counter() - t0) / steps
    dist_counts, dist_shapes = dict(_build.launch_counts), dict(_build.launch_shapes)
    assert dist_counts == {k: steps * sum(v) for k, v in per_step.items()}, dist_counts
    assert dict(_build.backward_counts) == {k: steps * v[1] for k, v in per_step.items() if v[1]}, \
        dict(_build.backward_counts)
    res["launches_per_distill_step"] = {k: v / steps for k, v in dist_counts.items()}

    student_counts, student_shapes = collections.Counter(), collections.Counter()
    res["students_si_sdr_db"], res["launches_per_student_eval"] = {}, {}
    for n, state_dict in students.items():
        model.score_model.load_state_dict(state_dict, strict=True)
        _build.reset_counts()
        si_sdr, nfe = score(n)
        got = dict(_build.launch_counts)
        assert nfe == n and got == {k: n * v[0] for k, v in eval_per_step.items()}, (n, nfe, got)
        assert np.isfinite(si_sdr), (n, si_sdr)
        res["students_si_sdr_db"][n] = si_sdr
        res["launches_per_student_eval"][n] = {k: v / nfe for k, v in got.items()}
        student_counts.update(got)
        student_shapes.update(_build.launch_shapes)
    return res, dist_counts, dist_shapes, dict(student_counts), dict(student_shapes)


def distill_demo_run(dev, card, model, state, demo, heldout, out):
    """Phase 15's distillation (see the module docstring) from the EMA
    weights of ``state``, through scripts/torch_port_distill_demo.py's batch
    stream; ``heldout`` the demo's held-out (mixtures, targets). Fills
    ``out["distill"]``. Returns the launches and launch shapes of the
    distill steps and of the students' evaluations."""
    import torch

    dist = demo_script("torch_port_distill_demo")
    t_part = time.perf_counter()
    stream = dist.BatchStream(0, demo.BATCH, demo.SAMPLES, dev)
    mix, tgt = (torch.from_numpy(a).to(dev) for a in heldout)
    res, *counts = smoke_distill(
        model, state, dist.stage_batches(stream, DEMO_DISTILL_STAGES, DEMO_DISTILL_STEPS), DEMO_DISTILL_STAGES,
        DEMO_DISTILL_STEPS, None, dist.DISTILL_SEED, DEMO_DISTILL_PER_STEP, DEMO_PER_STEP,
        lambda n: demo.heldout_si_sdr(model, mix, tgt, predictor_name="ddim", corrector_name="none", N=n))
    steps = len(DEMO_DISTILL_STAGES) * DEMO_DISTILL_STEPS
    assert stream.served == steps, (stream.served, steps)
    res["seconds"] = time.perf_counter() - t_part
    log(f"[demo] distillation {DEMO_DISTILL_STAGES} x {DEMO_DISTILL_STEPS} steps on the linear grid: "
        f"{res['s_per_distill_step']:.4f} s per distill step, launches per step {res['launches_per_distill_step']}; "
        f"students' ddim SI-SDR {res['students_si_sdr_db']} dB, launches per evaluation "
        f"{res['launches_per_student_eval']}; {res['seconds']:.1f} s in all ({card})")
    out["distill"] = res
    return counts


def demo_nr_phase(dev, card, cycles_per_ms, held):
    """Phase 16: the enhancement learning demo and its distillation; see the
    module docstring. ``held`` is the (kernel, shape, cout) keys phase 15
    held against the plain versions in bf16. Returns (report, launches over
    the phase's main-path runs: the training steps, the distill steps and
    the students' evaluation)."""
    import torch

    from diffsep_tpu_torch.ops import _build

    dist = demo_script("torch_port_distill_demo_nr")
    nr = dist.nr
    out = {}
    t_phase = time.perf_counter()

    # 1. training, through the script's loop (which sets the counts to 0
    # before its first step)
    model = nr.build_model("bfloat16", False, dev, seed=0)
    torch.cuda.reset_peak_memory_stats()
    run = nr.train(model, 0, NR_STEPS, np.random.default_rng(0), log=lambda m: log(f"[demo_nr] {m}"))
    counts, train_shapes = run["launches"], dict(run["launch_shapes"])
    train_plans = {plan: n for (k, plan), n in _build.launch_plans.items() if k == "conv3x3"}
    assert counts == {k: NR_STEPS * sum(v) for k, v in NR_PER_STEP.items()}, counts
    assert run["backward_launches"] == {k: NR_STEPS * v[1] for k, v in NR_PER_STEP.items() if v[1]}, \
        run["backward_launches"]
    cumulative = [{}] + run["window_launches"]
    windows = [dict(collections.Counter(b) - collections.Counter(a)) for a, b in zip(cumulative, cumulative[1:])]
    assert all(w == {k: 100 * sum(v) for k, v in NR_PER_STEP.items()} for w in windows), windows
    losses = run["losses"]
    assert np.isfinite(losses).all()
    first, last = float(losses[:10].mean()), float(losses[-100:].mean())
    out.update(steps=NR_STEPS, s_per_step=run["s_per_step"], train_s=run["train_time_s"],
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, loss_first=run["loss_first"],
               loss_mean_steps_1_10=first, loss_mean_last_100_steps=last,
               loss_mean_every100=[float(losses[i:i + 100].mean()) for i in range(0, NR_STEPS, 100)],
               launches_per_step={k: v / NR_STEPS for k, v in counts.items()},
               backward_launches_per_step={k: v / NR_STEPS for k, v in run["backward_launches"].items()})
    log(f"[demo_nr] {NR_STEPS} steps of 16 x 1 s at 16 kHz: {run['s_per_step']:.4f} s per step after the first, "
        f"peak {out['peak_mem_gib']:.2f} GiB; mean loss steps 1-10 {first:.4f}, last 100 {last:.4f} "
        f"(bar {DEMO_LOSS_RATIO} x); by 100 {out['loss_mean_every100']}; launches per step "
        f"{out['launches_per_step']}, backward {out['backward_launches_per_step']}, the same in each window "
        f"of 100 ({card})")
    assert last < DEMO_LOSS_RATIO * first, (first, last)
    c32 = sum(n for (k, shape, _), n in train_shapes.items() if k == "conv3x3" and c32_channels(shape[3]))
    out["conv_launches_per_step_by_plan"] = {plan: n / NR_STEPS for plan, n in sorted(train_plans.items())}
    assert c32 and train_plans.get("slice32", 0) == c32, (train_plans, c32)

    # 2. the noisy floors of the held-out set
    mix_te, tgt_te = nr.make_batch(np.random.default_rng(nr.HELDOUT_SEED), nr.HELDOUT_BATCH, nr.SAMPLES)
    si_floor, pesq_floor = nr.floors(mix_te, tgt_te)
    out["floors"] = {"si_sdr_noisy_floor_db": round(si_floor, 2), "pesq_wb_noisy_floor": round(pesq_floor, 3)}
    log(f"[demo_nr] noisy floors of the 8 held-out clips: {out['floors']} (want {NR_FLOORS})")
    assert all(abs(out["floors"][k] - v) <= tol + 1e-9 for k, (v, tol) in NR_FLOORS.items()), out["floors"]

    # 3. the distillation from the EMA weights, as the distill demo runs it
    # (over a pool of batches), and 4. each student's ddim SI-SDR on the
    # held-out clips
    drng = np.random.default_rng(dist.POOL_SEED)
    pool = [tuple(torch.from_numpy(a).to(dev) for a in nr.make_batch(drng, nr.BATCH, nr.SAMPLES))
            for _ in range(NR_DISTILL_POOL)]
    si_sdr = nr.metrics()[0]
    clean = torch.from_numpy(tgt_te[:, :1])

    def score(n):
        gen = torch.Generator(device=dev).manual_seed(nr.EVAL_SEED)
        est, nfe = model.separate(torch.from_numpy(mix_te).to(dev), generator=gen, predictor_name="ddim",
                                  corrector_name="none", N=n, schedule="log")
        return float(si_sdr(est[:, :1].float().cpu(), clean)), nfe

    res, dist_counts, dist_shapes, eval_counts, eval_shapes = smoke_distill(
        model, run["state"], lambda step: pool[step % len(pool)], NR_DISTILL_STAGES, NR_DISTILL_STEPS, "log",
        dist.DISTILL_SEED, NR_DISTILL_PER_STEP, NR_PER_STEP, score)
    out.update(s_per_distill_step=res["s_per_distill_step"], launches_per_distill_step=res["launches_per_distill_step"],
               students_si_sdr_db=res["students_si_sdr_db"])
    log(f"[demo_nr] distillation {NR_DISTILL_STAGES} x {NR_DISTILL_STEPS} steps: {out['s_per_distill_step']:.4f} s "
        f"per distill step, launches per step {out['launches_per_distill_step']}; students' ddim SI-SDR "
        f"{out['students_si_sdr_db']} dB ({card})")

    # 5. every kernel shape of these runs that phase 15 did not hold
    rows = []
    for i, key in enumerate(sorted((set(train_shapes) | set(dist_shapes) | set(eval_shapes)) - held, key=str)):
        rows.append(check_kernel(key[0], key[1], key[2], "bfloat16", dev, 1600 + i, cycles_per_ms))
    out["kernel_checks"] = rows
    bad = [r for r in rows if not r["ok"]]
    assert not bad, f"kernel mismatches at the enhancement demo's shapes: {bad}"
    total = collections.Counter(counts)
    total.update(dist_counts)
    total.update(eval_counts)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[demo_nr] {len(rows)} kernel shapes new to phase 16 held; phase 16 took {out['seconds']:.1f} s; "
        f"launches {dict(total)}")
    return out, dict(total)


def c32_channels(cin):
    """Input channels that the bf16 conv runs on 32-channel K slices."""
    return cin % 32 == 0 and cin % 64 != 0


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


def f32_lib_text(r):
    if "library_heuristic_ms" not in r:
        return ""
    split = f", split pass {r['split_ms']:.4f}" if "split_ms" in r else ""
    return (f" (cuDNN heuristic {r['library_heuristic_ms']:.4f}, benchmark {r['library_benchmark_ms']:.4f}){split}; "
            f"bound FFMA {r['bound_ffma_ms'] * 1e3:.3f} us, 3xTF32 {r['bound_3xtf32_ms'] * 1e3:.3f} us")


def f32_sums(rows, per, kind="conv3x3"):
    """The float32 rows of kernel ``kind`` summed over their launches
    (``per`` names the count): hand kernel ms by plan, plain, the library
    call (for the conv, cuDNN at its best and with its heuristic), the bound
    by plan (for the conv, also all at the FFMA peak and all as three TF32
    products), the conv's
    split pass as grad mode runs it, and the shapes where the hand kernel
    is slower than the library call at its best."""
    f32 = [r for r in rows if r["kernel"] == kind and r["dtype"] == "float32" and r.get("ms") is not None]

    def total(key):
        have = [r for r in f32 if r.get(key) is not None]
        return sum(r[key] * r[per] for r in have) if have else None

    by_plan = collections.defaultdict(float)
    for r in f32:
        by_plan[r["plan"]["variant"]] += r["ms"] * r[per]
    return dict(launches=sum(r[per] for r in f32), ms=total("ms"), ms_by_plan=dict(by_plan),
                plain_ms=total("plain_ms"), library_ms=total("library_ms"),
                library_heuristic_ms=total("library_heuristic_ms"), library_benchmark_ms=total("library_benchmark_ms"),
                bound_ms=total("bound_ms"), bound_ffma_ms=total("bound_ffma_ms"),
                bound_3xtf32_ms=total("bound_3xtf32_ms"), split_ms=total("split_ms"),
                slower_than_library=[[r["shape"], r["cout"], r["ms"], r["library_ms"]] for r in f32
                                     if r["ms"] > r["library_ms"]])


def f32_text(f):
    v = {k: "n/a" if x is None else f"{x:.3f}" for k, x in f.items() if not isinstance(x, (dict, list))}
    plans = ", ".join(f"{k} {x:.3f}" for k, x in sorted(f["ms_by_plan"].items()))
    return (f"hand {v['ms']} ms ({plans}; split passes {v['split_ms']} more in grad mode), plain "
            f"{v['plain_ms']}, cuDNN best {v['library_ms']} (heuristic {v['library_heuristic_ms']}, "
            f"benchmark {v['library_benchmark_ms']}), bound {v['bound_ms']} by plan ({v['bound_ffma_ms']} all at the "
            f"FFMA peak, {v['bound_3xtf32_ms']} all as 3 TF32 products); slower than cuDNN at "
            f"{f['slower_than_library']}")


def plan_text(plan):
    if "splits" in plan:  # conv3x3
        return (f" plan {plan['variant']} {plan['bm']}x{plan['bn']} stages {plan['stages']} "
                f"S {plan['splits']}")
    tile = f" x {plan['cols']} cols, stages {plan['stages']}" if plan["variant"] == "tma" else ""
    return f" plan {plan['variant']} strip {plan['rows']}{tile}, grid {tuple(plan['grid'])}"


def side_phases(dev, card, tmp):
    """Phases 12, 15, 16 and 11, in this order, in a process of their own:
    the whole run starts it after phase 6, which leaves its folder in the
    run's directory ``tmp`` and there, in side_held.json, the (kernel,
    shape, cout, dtype) keys that phases 3 and 6 held. Writes their results
    and launches to tmp/side.json."""
    from diffsep_tpu_torch.ops import _build

    for name in _build.KERNEL_SOURCES:
        _build.load(name)
    cycles_per_ms = sleep_cycles_per_ms()
    held = {(k, tuple(shape), cout, dt)
            for k, shape, cout, dt in json.loads((Path(tmp) / "side_held.json").read_text())}
    res = {}
    res["options"], res["option_counts"] = options_phase(dev, card, cycles_per_ms, tmp, Path(tmp) / "wsj0_mix", held)
    res["demo"], res["demo_counts"] = demo_phase(dev, card, cycles_per_ms)
    res["demo_nr"], res["demo_nr_counts"] = demo_nr_phase(
        dev, card, cycles_per_ms, {(r["kernel"], tuple(r["shape"]), r["cout"]) for r in res["demo"]["kernel_checks"]})
    res["diffuse"], res["diffuse_counts"] = diffuse_phase(dev, card, cycles_per_ms, tmp)
    (Path(tmp) / "side.json").write_text(json.dumps(res))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--report", type=Path, default=None, help="write every result to this JSON file")
    ap.add_argument("--side", type=Path, default=None,
                    help="run phases 12, 15, 16 and 11 alone in this directory of a whole run (which starts "
                         "them so, in a process of its own beside phases 7-14)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from diffsep_tpu_torch.model import DiffSepModel
    from diffsep_tpu_torch.ops import _build
    from diffsep_tpu_torch.ops.plain import plain_kernels

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
    if args.side is not None:
        return side_phases(dev, card, args.side)
    report = {"card": card}
    t_start = time.perf_counter()

    side, side_log = None, None  # the process of phases 12, 15, 16 and 11, from phase 7 on

    def mark(label):
        log(f"[time] {label}: {time.perf_counter() - t_start:.1f} s since the start")
        if side is not None and side.poll() not in (None, 0):
            log(side_log.read_text().rstrip())
            raise AssertionError(f"phases 12, 15, 16 and 11 exited with {side.returncode}")

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
                f"plain {r['plain_ms']:.4f} lib {r['library_ms']:.4f}{f32_lib_text(r)} "
                f"ms/lib {r['ms_per_library_ms']:.3g} {r['tflops']:.1f} TFLOP/s "
                f"bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")
    report["kernel_checks"] = results
    report["f32_conv_per_eval"] = f32 = f32_sums(results, "launches_per_eval")
    log(f"[kernel] float32 conv3x3 per flagship evaluation ({PER_EVAL['conv3x3']} launches): {f32_text(f32)} ({card})")
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

    mark("kernel and model phases done")
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
    mark("phase 5 done")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # 6. training phase
        report["train"] = train = train_phase(dev, card, cycles_per_ms, rng, tmp)
        mark("phase 6 done")
        # 12, 15, 16 and 11: in a process of their own beside phases 7-14
        # (most of every phase's time is the host's or its child processes')
        Path(tmp, "side_held.json").write_text(json.dumps(
            [[r["kernel"], r["shape"], r["cout"], r["dtype"]] for r in results + train["kernel_checks"]]))
        side_log = Path(tmp) / "side.log"
        with open(side_log, "w") as f:
            side = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--side", tmp],
                                    stdout=f, stderr=subprocess.STDOUT, cwd=Path(__file__).resolve().parent)
        try:
            # 7. serving entry points, on the run dir phase 6 wrote
            checked = {(r["kernel"], tuple(r["shape"]), r["cout"]) for r in results + train["kernel_checks"]
                       if r["dtype"] == "bfloat16"}
            report["serve_entry_points"], entry_counts = serve_entry_phase(
                dev, card, train["run_dir"], tmp, mix, (m_gpu, m_cpu), rng, checked)
            mark("phase 7 done")
            # 8. the enhancement recipe
            checked |= {(r["kernel"], tuple(r["shape"]), r["cout"])
                        for r in report["serve_entry_points"]["kernel_checks"]}
            report["enhance"], enh_counts = enhance_phase(dev, card, cycles_per_ms, tmp, (m_gpu, m_cpu), checked)
            mark("phase 8 done")
            # 9. distillation and the export artifact, on the run dir of phase 6
            checked |= {(r["kernel"], tuple(r["shape"]), r["cout"]) for r in report["enhance"]["kernel_checks"]}
            report["distill"], dist_counts = distill_phase(dev, card, train["run_dir"], tmp, (m_gpu, m_cpu), checked)
            mark("phase 9 done")
            # 10. data parallelism and multi-device evaluation
            checked |= {(r["kernel"], tuple(r["shape"]), r["cout"]) for r in report["distill"]["kernel_checks"]}
            report["ddp"], ddp_counts = ddp_phase(dev, card, tmp, train["run_dir"], Path(tmp) / "wsj0_mix", checked)
            mark("phase 10 done")
            # 13. FSDP, tensor parallelism, three speakers and the tools
            checked |= {(r["kernel"], tuple(r["shape"]), r["cout"]) for r in report["ddp"]["kernel_checks"]}
            report["slice12"], slice12_counts = slice12_phase(dev, card, cycles_per_ms, tmp, train["run_dir"],
                                                              Path(tmp) / "wsj0_mix", checked)
            mark("phase 13 done")
            # 14. the legacy blocks, the figures CLI, the native decoder
            report["legacy"], legacy_counts = legacy_phase(dev, card, cycles_per_ms, tmp, train["run_dir"],
                                                           Path(tmp) / "wsj0_mix")
            mark("phase 14 done")
            side.wait(timeout=1200)
        finally:
            if side.poll() is None:
                side.kill()
                side.wait()
        log(side_log.read_text().rstrip())
        assert side.returncode == 0, f"phases 12, 15, 16 and 11 exited with {side.returncode}"
        side_res = json.loads(Path(tmp, "side.json").read_text())
    mark("phases 12, 15, 16 and 11 done (beside phases 7-14)")
    report["options"], option_counts = side_res["options"], side_res["option_counts"]
    report["demo"], demo_counts = side_res["demo"], side_res["demo_counts"]
    report["demo_nr"], demo_nr_counts = side_res["demo_nr"], side_res["demo_nr_counts"]
    report["diffuse"], diffuse_counts = side_res["diffuse"], side_res["diffuse_counts"]

    # summary per kernel: the bf16 (serving) times summed over one score
    # evaluation's launches at batch 2 (the same in float32 apart, with the
    # f32 conv's plans, cuDNN heuristic and best, and both bounds; and the
    # f32 conv per f32 + remat micro-step of phase 12), and the bf16 times summed over one
    # training micro-step's launches (forward and backward) at batch 6 and
    # at the enhancement recipe's batch 4 x 3 s; launches over the main
    # paths: the serving run at N=30, the training run, the serving entry
    # points, the enhancement phase, distillation with the artifact and
    # phase 10 (its ranks' launches, reported by each rank's process)
    serve_counts = serve["reverse_diffusion+ald2 N=30"]["launches"]

    def set_backward(kernel):  # backward launches of each option set's micro-step, as phase 12 counted them
        return {name: v["micro_step"]["conv_backward"].get(kernel, 0) for name, v in report["options"]["sets"].items()}

    summary = []
    for k, meta in KERNELS.items():
        rows = [r for r in results if r["kernel"] == k]
        bf = [r for r in rows if r["dtype"] == "bfloat16"]
        tr = [r for r in train["kernel_checks"] if r["kernel"] == k]
        entry_rows = [r for r in report["serve_entry_points"]["kernel_checks"] if r["kernel"] == k]
        enh_rows = [r for r in report["enhance"]["kernel_checks"] if r["kernel"] == k]
        dist_rows = [r for r in report["distill"]["kernel_checks"] if r["kernel"] == k]
        ddp_rows = [r for r in report["ddp"]["kernel_checks"] if r["kernel"] == k]
        option_rows = [r for r in report["options"]["kernel_checks"] if r["kernel"] == k]
        slice12_rows = [r for r in report["slice12"]["kernel_checks"] if r["kernel"] == k]
        legacy_rows = [r for r in report["legacy"]["kernel_checks"] if r["kernel"] == k]
        demo_rows = [r for r in report["demo"]["kernel_checks"] + report["demo_nr"]["kernel_checks"]
                     if r["kernel"] == k]
        figure_counts = report["legacy"]["reverse_diffusion_example"]["launches"]
        if k == "fir_up2x":  # the down's backward at odd sizes runs the up kernel
            enh_rows += report["enhance"]["odd_fir_backward"]
        enh_tr = [r for r in enh_rows if "launches_per_micro_step" in r]

        def per_eval_sum(key):
            return sum(r[key] * r["launches_per_eval"] for r in bf)

        def per_step_sum(key, rows=tr):
            return sum(r[key] * r["launches_per_micro_step"] for r in rows)

        f32_remat = report["options"]["f32_remat_conv_per_micro_step"] if k == "conv3x3" else None
        summary.append(dict(
            name=k, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=(serve_counts[k] + train["launches"][k] + entry_counts[k] + enh_counts[k] + dist_counts[k]
                      + ddp_counts[k] + option_counts[k] + slice12_counts[k] + legacy_counts.get(k, 0)
                      + demo_counts[k] + demo_nr_counts[k]),
            max_abs_err=max(r["max_abs_err"] for r in rows + tr + entry_rows + enh_rows + dist_rows + ddp_rows
                            + option_rows + slice12_rows + legacy_rows + demo_rows),
            ms=per_eval_sum("ms"), plain_ms=per_eval_sum("plain_ms"),
            bound_ms=per_eval_sum("bound_ms"),
            bound_by="operations" if per_eval_sum("ops_ms") >= per_eval_sum("bytes_ms") else "bytes",
            library_ms=per_eval_sum("library_ms"),
            launches_by_path={"serve N=30": serve_counts[k], "train": train["launches"][k],
                              "train backward": train["backward_launches"].get(k, 0),
                              "serve entry points": entry_counts[k], "enhance": enh_counts[k],
                              "distill and artifact": dist_counts[k],
                              "ddp ranks, allgpus, preemption, evaluate_mp": ddp_counts[k],
                              "diffuse (phase 11)": diffuse_counts[k],
                              "NCSN++ options (phase 12)": option_counts[k],
                              "fsdp, tp=2, three speakers, tools (phase 13)": slice12_counts[k],
                              "legacy blocks (phase 14)": legacy_counts.get(k, 0) - figure_counts[k],
                              "figures reverse_diffusion_example (phase 14)": figure_counts[k],
                              "learning demo, training, evaluation, distillation and students (phase 15)":
                                  demo_counts[k],
                              "enhancement demo, training, distillation and students (phase 16)":
                                  demo_nr_counts[k]},
            launches_per_demo_step={"forward": DEMO_PER_STEP[k][0], "backward": DEMO_PER_STEP[k][1]},
            launches_per_nr_demo_step={"forward": NR_PER_STEP[k][0], "backward": NR_PER_STEP[k][1]},
            launches_per_demo_distill_step={"forward": DEMO_DISTILL_PER_STEP[k][0],
                                            "backward": DEMO_DISTILL_PER_STEP[k][1]},
            launches_per_nr_distill_step={"forward": NR_DISTILL_PER_STEP[k][0],
                                          "backward": NR_DISTILL_PER_STEP[k][1]},
            demo_launches_per_step_by_plan=report["demo"]["conv_launches_per_step_by_plan"] if k == "conv3x3"
            else None,
            demo_ms_per_step=report["demo"]["ms_per_step"][k],
            launches_per_legacy_set_ngf128=sum(r["launches_per_legacy_set"] for r in legacy_rows),
            legacy_f32_per_set={key: sum(r[key] * r["launches_per_legacy_set"] for r in legacy_rows)
                                for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
            launches_per_reverse_diffusion_example=figure_counts[k],
            launches_per_eval_tp2_per_rank=PER_EVAL[k], launches_per_eval_three_speakers=PER_EVAL[k],
            tp2_ms_per_eval_new_shapes=report["slice12"]["tp_kernel_ms_per_eval"][k],
            phase13_shapes=[dict(path=r["path"], shape=r["shape"], cout=r["cout"], plan=r["plan"],
                                 max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                                 library_ms=r["library_ms"], bound_ms=r["bound_ms"],
                                 launches_per_eval=r["launches_per_eval"]) for r in slice12_rows],
            launches_per_ddp_micro_step_per_rank={"forward": TRAIN_PER_STEP[k][0], "backward": TRAIN_PER_STEP[k][1]},
            launches_per_distill_step={"forward": 3 * PER_EVAL[k], "backward": TRAIN_PER_STEP[k][1]},
            launches_per_micro_step={"forward": TRAIN_PER_STEP[k][0], "backward": TRAIN_PER_STEP[k][1]},
            train_ms_per_micro_step=per_step_sum("ms"), train_plain_ms=per_step_sum("plain_ms"),
            train_bound_ms=per_step_sum("bound_ms"), train_library_ms=per_step_sum("library_ms"),
            enhance_train_ms_per_micro_step=per_step_sum("ms", enh_tr),
            enhance_train_plain_ms=per_step_sum("plain_ms", enh_tr),
            enhance_train_bound_ms=per_step_sum("bound_ms", enh_tr),
            enhance_train_library_ms=per_step_sum("library_ms", enh_tr),
            float32_per_eval=f32_sums(rows, "launches_per_eval", k),
            float32_per_f32_remat_micro_step=f32_remat,
            float32_dx_per_f32_remat_micro_step=(report["options"]["f32_remat_backward_per_micro_step"]["dx"]
                                                 if k == "conv3x3" else None),
            dx_launches_per_option_set_micro_step=(set_backward("conv3x3") if k == "conv3x3" else None),
        ))
    # the f32 conv's weight gradient: launches over every path, its errors
    # and times at the f32 + remat micro-step's shapes (phase 12), summed
    # over that micro-step's launches
    counters = [serve_counts, train["launches"], entry_counts, enh_counts, dist_counts, ddp_counts, option_counts,
                slice12_counts, legacy_counts, demo_counts, demo_nr_counts]
    dw_rows = [r for r in report["options"]["f32_remat_backward_checks"] if r["part"] == "dw"]
    dw = report["options"]["f32_remat_backward_per_micro_step"]["dw"]
    summary.append(dict(
        name="conv3x3_dw", route="cuda", source=DW_KERNEL["source"], replaces=DW_KERNEL["replaces"],
        launches=sum(c.get("conv3x3_dw", 0) for c in counters),
        max_abs_err=max(r["max_abs_err"] for r in dw_rows), ms=dw["ms"], plain_ms=dw["plain_ms"],
        bound_ms=dw["bound_ms"], bound_by=dw["bound_by"],
        library_ms=dw["library_ms"], per="f32 + remat micro-step", max_rel_err=dw["max_rel_err"],
        ms_by_plan=dw["ms_by_plan"], bound_ffma_ms=dw["bound_ffma_ms"], bound_3xtf32_ms=dw["bound_3xtf32_ms"],
        by_group=dw["by_group"], launches_per_f32_remat_micro_step=dw["launches"],
        launches_per_option_set_micro_step=set_backward("conv3x3_dw"),
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
