"""DiffSepModel: the separation model (score network + SDE + sampler).

Counterpart of the inference part of ``diffsep_tpu/model.py``. The model is
built from a plain dict whose defaults are the flagship separation model of
the ICASSP 2023 recipe (``config/yaml/model/default.yaml`` with
``experiment/icassp-separation.yaml``): NCSN++ nf=128 computing in bf16,
STFT 510/128, MixSDE with 30 steps, reverse_diffusion + ald2 at snr 0.5.
"""
from __future__ import annotations

import copy
import warnings
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from . import resolve_device
from .models.ncsnpp import NCSNpp
from .models.score_model import ScoreModelNCSNpp
from .sampling.pc import pc_sample
from .sde.mixsde import MixSDE

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


def normalize_batch(mix: Tensor):
    """Normalize by the mixture's mean and std over (chan, time); the std is
    Bessel-corrected and clamped at 1e-5."""
    mean = mix.mean(dim=(1, 2), keepdim=True)
    std = torch.clamp(mix.std(dim=(1, 2), keepdim=True, correction=1), min=1e-5)
    return (mix - mean) / std, mean, std


def denormalize_batch(x: Tensor, mean: Tensor, std: Tensor) -> Tensor:
    return x * std + mean


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


def build_score_model(cfg: Mapping[str, Any]) -> ScoreModelNCSNpp:
    n_src = int(cfg["n_speakers"])
    sm = cfg["score_model"]
    backbone = NCSNpp(
        num_channels_in=2 * n_src + 2, num_channels_out=2 * n_src, **sm["backbone_args"]
    )
    return ScoreModelNCSNpp(
        backbone,
        num_sources=n_src,
        n_fft=int(sm["stft_args"]["n_fft"]),
        hop_length=int(sm["stft_args"]["hop_length"]),
        spec_abs_exponent=float(sm["spec_abs_exponent"]),
        spec_factor=float(sm["spec_factor"]),
    )


class DiffSepModel(nn.Module):
    """Score model + MixSDE + PC sampler on one device.

    config: overrides of ``FLAGSHIP`` (nested dict). device: where it runs,
    CUDA unless the caller asks otherwise. seed: the weights are drawn with
    the JAX package's initializers from this seed; load a state dict to
    replace them.
    """

    def __init__(self, config: Optional[Mapping[str, Any]] = None, device=None, seed: int = 0):
        super().__init__()
        self.config = merge_config(FLAGSHIP, config)
        cfg = self.config
        self.device = resolve_device(device)
        self.score_model = build_score_model(cfg)
        self.score_model.backbone.reset_parameters(torch.Generator().manual_seed(seed))
        self.score_model.to(self.device).eval()
        self.sde = MixSDE(ndim=int(cfg["n_speakers"]), **cfg["sde"])
        self.t_eps = float(cfg["t_eps"])
        self.sampler_kwargs = dict(cfg.get("sampler", {}))

    def score_fn(self, x: Tensor, t: Tensor, mix: Tensor) -> Tensor:
        return self.score_model(x, t, mix)

    @torch.no_grad()
    def separate(self, mix, generator: Optional[torch.Generator] = None,
                 noise: Optional[Dict[str, Tensor]] = None, **kwargs):
        """Separate mixtures (batch, 1, n_samples) -> (estimates (batch,
        n_src, n_samples), nfe). Keyword arguments override the sampler
        settings (predictor_name, corrector_name, N, snr, schedule, ...)."""
        kw = dict(predictor_name="reverse_diffusion", corrector_name="ald2", eps=self.t_eps)
        kw.update(self.sampler_kwargs)
        kw.update(kwargs)
        _warn_low_n_schedule(self.sde, kw["predictor_name"], kw.get("N"), kw.get("schedule"))
        if isinstance(mix, np.ndarray):
            mix = torch.from_numpy(mix)
        mix = mix.to(device=self.device, dtype=torch.float32)
        mix_n, mean, std = normalize_batch(mix)
        est, nfe = pc_sample(
            self.sde, self.score_fn, mix_n, generator=generator, noise=noise, **kw
        )
        return denormalize_batch(est, mean, std), nfe
