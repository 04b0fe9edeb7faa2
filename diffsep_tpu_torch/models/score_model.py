"""Time-domain score model: STFT frontend + NCSN++ backbone.

Counterpart of ``diffsep_tpu/models/score_model.py``. The score network takes
the diffused sources x_t and the mixture, maps them through STFT ->
magnitude compression -> real/imag channel stacking -> frame padding ->
backbone -> the inverse chain, and returns a time-domain score of the
input's length. Every frontend option of the JAX class is here: the
magnitude transform ("exponent", "log" or "none"), learnable transform
constants, and a centered or uncentered STFT.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stft import istft, stft

Tensor = torch.Tensor


def _phase(spec: Tensor) -> Tensor:
    mag = spec.abs()
    one = torch.ones((), dtype=spec.dtype, device=spec.device)
    return torch.where(mag > 0, spec / torch.clamp(mag, min=1e-37), one)


class ScoreModelNCSNpp(nn.Module):
    """Callable as (x_t (batch, num_sources, samples), time_cond (batch,),
    mix (batch, 1, samples)) -> score (batch, num_sources, samples).

    The magnitude transform is "exponent" (|X|^e with the phase kept, times
    a factor), "log" (log(1 + |X|) with the phase, times |factor|) or
    "none". With ``spec_trans_learnable`` the exponent and the factor are
    scalar parameters ``spec_abs_exponent`` and ``spec_factor``, used as
    |e| and factor (|factor| on the way back), trained and saved like the
    others. Frames are padded to a multiple of 64 = 2^(levels - 1) so every
    U-Net level divides evenly."""

    FRAME_PAD_MULTIPLE = 64

    def __init__(
        self,
        backbone: nn.Module,
        num_sources: int = 2,
        n_fft: int = 510,
        hop_length: int = 128,
        center: bool = True,
        transform: str = "exponent",
        spec_abs_exponent: float = 0.5,
        spec_factor: float = 3.0,
        spec_trans_learnable: bool = False,
    ):
        super().__init__()
        if transform not in ("exponent", "log", "none"):
            raise ValueError("transform must be one of 'exponent'|'log'|'none'")
        self.backbone = backbone
        self.num_sources = num_sources
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.center = center
        self.transform = transform
        self.spec_trans_learnable = spec_trans_learnable
        if spec_trans_learnable:
            self.spec_abs_exponent = nn.Parameter(torch.tensor(float(spec_abs_exponent)))
            self.spec_factor = nn.Parameter(torch.tensor(float(spec_factor)))
        else:
            self.spec_abs_exponent = spec_abs_exponent
            self.spec_factor = spec_factor

    def _consts(self):
        """(|exponent|, factor): parameters where learnable, else floats."""
        if self.spec_trans_learnable:
            return self.spec_abs_exponent.abs(), self.spec_factor
        return abs(self.spec_abs_exponent), self.spec_factor

    def _reshape_magnitude(self) -> bool:
        return self.spec_trans_learnable or self.spec_abs_exponent != 1

    def transform_forward(self, spec: Tensor) -> Tensor:
        e, factor = self._consts()
        if self.transform == "exponent":
            if self._reshape_magnitude():
                spec = spec.abs() ** e * _phase(spec)
            return spec * factor
        if self.transform == "log":
            return torch.log1p(spec.abs()) * _phase(spec) * abs(factor)
        return spec

    def transform_backward(self, spec: Tensor) -> Tensor:
        e, factor = self._consts()
        if self.transform == "exponent":
            spec = spec / abs(factor)
            if self._reshape_magnitude():
                spec = spec.abs() ** (1.0 / e) * _phase(spec)
            return spec
        if self.transform == "log":
            spec = spec / abs(factor)
            return (torch.exp(spec.abs()) - 1.0) * _phase(spec)
        return spec

    @staticmethod
    def complex_to_real(x: Tensor) -> Tensor:
        """(batch, chan, freq, frames) complex -> (batch, freq, frames,
        2 * chan) real, ordered [re_c0..re_cn, im_c0..im_cn]."""
        return torch.cat([x.real, x.imag], dim=1).permute(0, 2, 3, 1)

    @staticmethod
    def real_to_complex(x: Tensor) -> Tensor:
        x = x.permute(0, 3, 1, 2)
        c = x.shape[1] // 2
        return torch.complex(x[:, :c].contiguous(), x[:, c:].contiguous())

    def pad_frames(self, x: Tensor):
        rem = x.shape[-2] % self.FRAME_PAD_MULTIPLE
        if rem == 0:
            return x, 0
        pad = self.FRAME_PAD_MULTIPLE - rem
        return F.pad(x, (0, 0, 0, pad)), pad

    def pre_process(self, x: Tensor):
        """(batch, chan, samples) -> (batch, freq, frames (padded), 2 chan)."""
        n_samples = x.shape[-1]
        x = F.pad(x, (0, self.n_fft - self.hop_length))
        spec = stft(x, self.n_fft, self.hop_length, center=self.center)
        xr, n_pad = self.pad_frames(self.complex_to_real(self.transform_forward(spec)))
        return xr.contiguous(), n_samples, n_pad

    def post_process(self, x: Tensor, n_samples: int, n_pad: int) -> Tensor:
        if n_pad:
            x = x[:, :, :-n_pad, :]
        spec = self.transform_backward(self.real_to_complex(x))
        return istft(spec, self.n_fft, self.hop_length, center=self.center, length=n_samples)

    def forward(self, xt: Tensor, time_cond: Tensor, mix: Tensor) -> Tensor:
        h, n_samples, n_pad = self.pre_process(torch.cat((xt, mix), dim=1))
        return self.post_process(self.backbone(h, time_cond), n_samples, n_pad)
