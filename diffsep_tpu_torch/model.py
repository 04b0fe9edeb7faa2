"""DiffSepModel: the separation model (score network + SDE + sampler) and
its training setup.

Counterpart of ``diffsep_tpu/model.py``. The model is built from a composed
config (``config.compose``: its ``model`` and ``trainer`` nodes) or from a
plain dict of overrides of ``FLAGSHIP``, whose defaults are the flagship
separation model of the ICASSP 2023 recipe (``model/default.yaml`` with
``experiment/icassp-separation.yaml``): NCSN++ nf=128 computing in bf16,
STFT 510/128, MixSDE with 30 steps, reverse_diffusion + ald2 at snr 0.5,
and the recipe's loss (init hack 5) and optimizer (Adam 2e-4, fixed clip
5, EMA 0.999). Parameters, EMA and optimizer state are in a ``TrainState``
(``train/trainer.py``) around the model's parameters.
"""
from __future__ import annotations

import copy
import warnings
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from . import resolve_device
from .config.compose import instantiate
from .models.ncsnpp import NCSNpp
from .models.score_model import ScoreModelNCSNpp
from .sampling.pc import pc_sample
from .sde.mixsde import MixSDE
from .train import trainer
from .train.losses import denormalize_batch, normalize_batch

Tensor = torch.Tensor

FLAGSHIP: Dict[str, Any] = {
    "n_speakers": 2,
    "fs": 8000,
    "t_eps": 0.03,
    "score_model": {
        "stft_args": {"n_fft": 510, "hop_length": 128},
        "backbone_args": {
            "nf": 128,
            "ch_mult": (1, 1, 2, 2, 2, 2, 2),
            "num_res_blocks": 2,
            "attn_resolutions": (16,),
            "image_size": 256,
            "fir_kernel": (1, 3, 3, 1),
            "dtype": "bfloat16",
        },
        "spec_abs_exponent": 0.5,
        "spec_factor": 0.15,
    },
    "sde": {"d_lambda": 2.0, "sigma_min": 0.05, "sigma_max": 0.5, "N": 30},
    "sampler": {"N": 30, "snr": 0.5, "corrector_steps": 1},
    "t_rev_init": 0.03,
    "ema_decay": 0.999,
    "valid_max_sep_batches": 2,
    "time_sampling_strategy": "uniform",
    "train_source_order": "power",
    "init_hack": 5,
    "init_hack_p": 0.1,
    "mmnr_thresh_pit": -10.0,
    "val_losses": {"val/si_sdr": {
        "_target_": "diffsep_tpu_torch.models.losses.SISDRLoss",
        "zero_mean": True, "clamp_db": 30, "reduction": "mean", "sign_flip": True,
    }},
    "optimizer": {"lr": 2e-4, "weight_decay": 0.0},
    "lr_warmup": None,
    "scheduler": None,
    "grad_clipper": {"_target_": "diffsep_tpu_torch.train.clippers.FixedClipper", "max_norm": 5.0},
}


def merge_config(base: Mapping[str, Any], overrides: Optional[Mapping[str, Any]]) -> Dict[str, Any]:
    """Deep merge of nested dicts; `overrides` wins."""
    out = copy.deepcopy(dict(base))
    for k, v in (overrides or {}).items():
        if isinstance(v, Mapping) and isinstance(out.get(k), Mapping):
            out[k] = merge_config(out[k], v)
        else:
            out[k] = v
    return out


def _warn_low_n_schedule(sde, predictor_name, N, schedule):
    """DDIM at N <= 2 on the linear grid degenerates; the log grid does not."""
    n_eff = sde.N if N is None else int(N)
    if predictor_name == "ddim" and n_eff <= 2 and schedule in (None, "linear"):
        grid = "default linear" if schedule is None else "linear"
        warnings.warn(
            f"predictor '{predictor_name}' with N={n_eff} on the {grid} time "
            "grid degenerates; pass schedule='log'",
            stacklevel=3,
        )


def _unsupported(what: str, value) -> NotImplementedError:
    return NotImplementedError(f"{what}={value!r} is not ported to diffsep_tpu_torch yet")


def build_score_model(cfg: Mapping[str, Any]) -> ScoreModelNCSNpp:
    n_src = int(cfg["n_speakers"])
    sm = cfg["score_model"]
    backbone_args = dict(sm["backbone_args"])
    target = backbone_args.pop("_target_", "NCSNpp")
    if not target.endswith("NCSNpp"):
        raise _unsupported("backbone", target)
    if backbone_args.pop("remat", False):
        raise _unsupported("remat", True)
    for key, supported in (("transform", "exponent"), ("spec_trans_learnable", False)):
        if sm.get(key, supported) != supported:
            raise _unsupported(key, sm[key])
    if not sm["stft_args"].get("center", True):
        raise _unsupported("stft_args.center", False)
    backbone = NCSNpp(num_channels_in=2 * n_src + 2, num_channels_out=2 * n_src, **backbone_args)
    return ScoreModelNCSNpp(
        backbone,
        num_sources=n_src,
        n_fft=int(sm["stft_args"]["n_fft"]),
        hop_length=int(sm["stft_args"]["hop_length"]),
        spec_abs_exponent=float(sm["spec_abs_exponent"]),
        spec_factor=float(sm["spec_factor"]),
    )


def _build_sde(cfg: Mapping[str, Any]) -> MixSDE:
    args = {k: v for k, v in cfg["sde"].items() if k not in ("_target_", "ndim")}
    target = cfg["sde"].get("_target_", "MixSDE")
    if not target.endswith(".MixSDE") and target != "MixSDE":
        raise _unsupported("sde", target)
    return MixSDE(ndim=int(cfg["n_speakers"]), **args)


def _optim_config(m: Mapping[str, Any], trainer_cfg: Mapping[str, Any]) -> trainer.OptimConfig:
    """The optimizer settings of a model node, as the JAX package reads them."""
    clip = m.get("grad_clipper") or {}
    clip_target = clip.get("_target_", "")
    if clip_target.endswith("FixedClipper"):
        clip_kind = "fixed"
    elif clip_target.endswith("AutoClipper"):
        clip_kind = "autoclip"
    else:
        clip_kind = "none"
    sched = m.get("scheduler") or {}
    target = sched.get("_target_", "")
    scheduler = {"ExponentialLR": "exponential", "StepLR": "step", "CosineAnnealingLR": "cosine"}.get(
        target.rpartition(".")[2], sched.get("name"))
    return trainer.OptimConfig(
        lr=float(m["optimizer"]["lr"]),
        weight_decay=float(m["optimizer"].get("weight_decay", 0.0)),
        lr_warmup=m.get("lr_warmup"),
        accumulate_grad_batches=int(trainer_cfg.get("accumulate_grad_batches", 1)),
        ema_decay=float(m.get("ema_decay", 0.999)),
        grad_clipper=clip_kind,
        clip_max_norm=float(clip.get("max_norm", 5.0)),
        autoclip_percentile=float(clip.get("p", 10.0)),
        scheduler=scheduler,
        scheduler_gamma=float(sched.get("gamma", 0.99)),
        scheduler_step_size=int(sched.get("step_size", 1000)),
        scheduler_t_max=int(sched.get("T_max", 100000)),
    )


class DiffSepModel(nn.Module):
    """Score model + MixSDE + PC sampler on one device, with its training
    setup.

    config: a composed config (its ``model`` and ``trainer`` nodes), or
    overrides of ``FLAGSHIP`` (nested dict). device: where it runs, CUDA
    unless the caller asks otherwise. seed: the weights are drawn with the
    JAX package's initializers from this seed; load a state dict to replace
    them.
    """

    def __init__(self, config: Optional[Mapping[str, Any]] = None, device=None, seed: int = 0):
        super().__init__()
        trainer_cfg: Mapping[str, Any] = {}
        if config is not None and "model" in config:
            trainer_cfg = config.get("trainer") or {}
            config = config["model"]
        self.config = merge_config(FLAGSHIP, config)
        cfg = self.config
        self.device = resolve_device(device)
        self.score_model = build_score_model(cfg)
        self.score_model.backbone.reset_parameters(torch.Generator().manual_seed(seed))
        self.score_model.to(self.device).eval()
        self.sde = _build_sde(cfg)
        self.t_eps = float(cfg["t_eps"])
        self.sampler_kwargs = dict(cfg.get("sampler", {}))
        self.loss_cfg = trainer.LossConfig(
            t_eps=self.t_eps,
            t_rev_init=float(cfg.get("t_rev_init", 0.03)),
            init_hack=cfg.get("init_hack", False),
            init_hack_p=float(cfg.get("init_hack_p", 1.0 / self.sde.N)),
            train_source_order=str(cfg.get("train_source_order", "random")),
            mmnr_thresh_pit=float(cfg.get("mmnr_thresh_pit", -10.0)),
            time_sampling_strategy=cfg.get("time_sampling_strategy", "uniform"),
        )
        self.optim_cfg = _optim_config(cfg, trainer_cfg)
        self.valid_max_sep_batches = int(cfg.get("valid_max_sep_batches", 1))
        self.val_losses = {name: instantiate(args) for name, args in (cfg.get("val_losses") or {}).items()}

    def score_fn(self, x: Tensor, t: Tensor, mix: Tensor) -> Tensor:
        return self.score_model(x, t, mix)

    # --- training ---
    def init_state(self) -> trainer.TrainState:
        return trainer.init_train_state(self.score_model, self.optim_cfg)

    def make_train_step(self, seed: int):
        return trainer.make_train_step(self.score_model, self.sde, self.loss_cfg, self.optim_cfg, seed)

    def make_val_loss(self, seed: int):
        return trainer.make_val_score_loss(self.score_model, self.sde, self.loss_cfg, seed)

    # --- inference ---
    @torch.no_grad()
    def separate(self, mix, generator: Optional[torch.Generator] = None,
                 noise: Optional[Dict[str, Tensor]] = None, **kwargs):
        """Separate mixtures (batch, 1, n_samples) -> (estimates (batch,
        n_src, n_samples), nfe) with the weights the model holds (inside
        ``train.ema.swapped``: the EMA weights). Keyword arguments override
        the sampler settings (predictor_name, corrector_name, N, snr,
        schedule, ...)."""
        kw = dict(predictor_name="reverse_diffusion", corrector_name="ald2", eps=self.t_eps)
        kw.update(self.sampler_kwargs)
        kw.update(kwargs)
        _warn_low_n_schedule(self.sde, kw["predictor_name"], kw.get("N"), kw.get("schedule"))
        if isinstance(mix, np.ndarray):
            mix = torch.from_numpy(mix)
        mix = mix.to(device=self.device, dtype=torch.float32)
        (mix_n, _), mean, std = normalize_batch(mix)
        est, nfe = pc_sample(
            self.sde, self.score_fn, mix_n, generator=generator, noise=noise, **kw
        )
        return denormalize_batch(est, mean, std), nfe
