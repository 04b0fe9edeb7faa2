"""NCSN++ score-network backbone on NHWC activations.

Counterpart of ``diffsep_tpu/models/ncsnpp.py`` for the configuration the
separation models use, which is the JAX class's defaults: BigGAN residual
blocks with FIR resampling and skip_rescale, output_skip / input_skip
pyramids combined by sum, Fourier time embedding (scale 16) of log(t),
swish, init_scale 0, a [0, 1] -> [-1, 1] input map and the score divided
by t. Submodules are built in the reference's constructor order into
``all_modules``, so the parameters are named ``all_modules.<i>.*`` like the
reference checkpoints, and the forward pass walks them with a moving index
and the same asserts.

Input x: (batch, freq, frames, channels_in). With dtype "bfloat16" the
backbone computes in bf16 while the time embedding, the score scaling and
the output projection stay float32.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import layers

Tensor = torch.Tensor

INIT_SCALE = 0.0
FOURIER_SCALE = 16.0


class NCSNpp(nn.Module):
    def __init__(
        self,
        nf: int = 128,
        ch_mult: Sequence[int] = (1, 1, 2, 2, 2, 2, 2),
        num_res_blocks: int = 2,
        attn_resolutions: Sequence[int] = (16,),
        fir_kernel: Sequence[float] = (1, 3, 3, 1),
        image_size: int = 256,
        num_channels_in: int = 4,
        num_channels_out: int = 4,
        dtype: str = "float32",
    ):
        super().__init__()
        self.nf = nf
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        self.compute_dtype = torch.bfloat16 if dtype in ("bfloat16", "bf16") else torch.float32

        num_resolutions = len(self.ch_mult)
        all_resolutions = [image_size // (2**i) for i in range(num_resolutions)]

        def attn(ch):
            return layers.AttnBlockpp(ch, init_scale=INIT_SCALE)

        def resnet(in_ch, out_ch, up=False, down=False):
            return layers.ResnetBlockBigGANpp(
                in_ch, out_ch, temb_dim=4 * nf, up=up, down=down,
                fir_kernel=fir_kernel, init_scale=INIT_SCALE,
            )

        modules = [
            layers.GaussianFourierProjection(embedding_size=nf, scale=FOURIER_SCALE),
            layers.Dense(2 * nf, 4 * nf),
            layers.Dense(4 * nf, 4 * nf),
        ]
        self.pyramid_upsample = layers.Upsample(fir_kernel)
        self.pyramid_downsample = layers.Downsample(fir_kernel)

        channels = num_channels_in
        modules.append(layers.conv3x3(channels, nf))
        hs_c = [nf]
        in_ch = nf
        for i_level in range(num_resolutions):
            for _ in range(num_res_blocks):
                out_ch = nf * self.ch_mult[i_level]
                modules.append(resnet(in_ch, out_ch))
                in_ch = out_ch
                if all_resolutions[i_level] in self.attn_resolutions:
                    modules.append(attn(in_ch))
                hs_c.append(in_ch)
            if i_level != num_resolutions - 1:
                modules.append(resnet(in_ch, in_ch, down=True))
                modules.append(layers.Combine(channels, in_ch))
                hs_c.append(in_ch)

        in_ch = hs_c[-1]
        modules.append(resnet(in_ch, in_ch))
        modules.append(attn(in_ch))
        modules.append(resnet(in_ch, in_ch))

        for i_level in reversed(range(num_resolutions)):
            for _ in range(num_res_blocks + 1):
                out_ch = nf * self.ch_mult[i_level]
                modules.append(resnet(in_ch + hs_c.pop(), out_ch))
                in_ch = out_ch
            if all_resolutions[i_level] in self.attn_resolutions:
                modules.append(attn(in_ch))
            modules.append(layers.group_norm(in_ch))
            modules.append(layers.conv3x3(in_ch, channels, init_scale=INIT_SCALE))
            if i_level != 0:
                modules.append(resnet(in_ch, in_ch, up=True))

        assert not hs_c, "skip-channel bookkeeping mismatch"
        self.all_modules = nn.ModuleList(modules)
        # final 1x1 projection back to the score channels, float32
        self.output_layer = layers.conv1x1(channels, num_channels_out)

    def reset_parameters(self, generator=None) -> None:
        """Seeded init mirroring the JAX package's initializers (DDPM
        variance scaling; lecun normal for the output projection)."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        w = self.output_layer.weight
        std = (1.0 / w.shape[1]) ** 0.5 / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)

    def forward(self, x: Tensor, time_cond: Tensor) -> Tensor:
        modules = self.all_modules
        act = F.silu
        cdtype = self.compute_dtype
        num_resolutions = len(self.ch_mult)

        used_sigmas = time_cond
        temb = modules[0](torch.log(used_sigmas))
        temb = modules[1](temb)
        temb = modules[2](act(temb)).to(cdtype)
        m_idx = 3

        # the reference keeps the [0, 1] -> [-1, 1] map for spectrograms
        x = (2 * x - 1.0).to(cdtype)

        input_pyramid = x
        hs = [modules[m_idx](x)]
        m_idx += 1
        for i_level in range(num_resolutions):
            for _ in range(self.num_res_blocks):
                h = modules[m_idx](hs[-1], temb)
                m_idx += 1
                # audio edit: attend when the *frequency* axis matches
                if h.shape[1] in self.attn_resolutions:
                    assert isinstance(modules[m_idx], layers.AttnBlockpp)
                    h = modules[m_idx](h)
                    m_idx += 1
                hs.append(h)
            if i_level != num_resolutions - 1:
                h = modules[m_idx](hs[-1], temb)
                m_idx += 1
                input_pyramid = self.pyramid_downsample(input_pyramid)
                h = modules[m_idx](input_pyramid, h)
                m_idx += 1
                hs.append(h)

        h = hs[-1]
        h = modules[m_idx](h, temb)
        h = modules[m_idx + 1](h)
        h = modules[m_idx + 2](h, temb)
        m_idx += 3

        pyramid = None
        for i_level in reversed(range(num_resolutions)):
            for _ in range(self.num_res_blocks + 1):
                h = modules[m_idx](torch.cat([h, hs.pop()], dim=-1), temb)
                m_idx += 1
            if h.shape[1] in self.attn_resolutions:
                assert isinstance(modules[m_idx], layers.AttnBlockpp)
                h = modules[m_idx](h)
                m_idx += 1
            # GroupNorm statistics in f32, activations back in cdtype
            pyramid_h = act(modules[m_idx](h)).to(cdtype)
            pyramid_h = modules[m_idx + 1](pyramid_h)
            m_idx += 2
            if i_level == num_resolutions - 1:
                pyramid = pyramid_h
            else:
                pyramid = self.pyramid_upsample(pyramid) + pyramid_h
            if i_level != 0:
                h = modules[m_idx](h, temb)
                m_idx += 1

        assert not hs, "skip stack must be exhausted"
        assert m_idx == len(modules), "module walk mismatch"

        # score scaling and output projection in float32
        h = pyramid.float() / used_sigmas.reshape((-1,) + (1,) * (pyramid.ndim - 1))
        return self.output_layer(h)
