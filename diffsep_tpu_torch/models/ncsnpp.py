"""NCSN++ score-network backbone on NHWC activations.

Counterpart of ``diffsep_tpu/models/ncsnpp.py``, with every field of the
JAX class and its default: BigGAN or DDPM residual blocks, FIR or naive
resampling with or without convs, output_skip / residual / no output
pyramid, input_skip / residual / no input pyramid combined by sum or cat,
Fourier (of log t) or positional (of t) time embedding, any activation,
conditional or not, centered or not, the score divided by t or not, and
remat. Submodules are built in the reference's constructor order into
``all_modules``, so the parameters are named ``all_modules.<i>.*`` like the
reference checkpoints, and the forward pass walks them with a moving index
and the same asserts.

Input x: (batch, freq, frames, channels_in). With dtype "bfloat16" the
backbone computes in bf16 while the time embedding, the score scaling and
the output projection stay float32; where the JAX package's dtype
promotion turns a bf16 activation into f32 (a residual pyramid's sum
divided by a numpy sqrt(2), the f32 resample convs of ``fir=False``, the
last conv without an output pyramid), the port casts to f32 at the same
point, and what follows computes in f32 in both.

``dropout`` is accepted and applies nothing: the JAX package never calls
the backbone with ``train=True``, so its dropout is never active.
``remat`` recomputes each residual and attention block in the backward
(``torch.utils.checkpoint``), as the JAX package ``nn.remat``s those three
classes; the parameters are the same.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import layers

Tensor = torch.Tensor


class NCSNpp(nn.Module):
    def __init__(
        self,
        scale_by_sigma: bool = True,
        nonlinearity: str = "swish",
        nf: int = 128,
        ch_mult: Sequence[int] = (1, 1, 2, 2, 2, 2, 2),
        num_res_blocks: int = 2,
        attn_resolutions: Sequence[int] = (16,),
        resamp_with_conv: bool = True,
        conditional: bool = True,
        fir: bool = True,
        fir_kernel: Sequence[float] = (1, 3, 3, 1),
        skip_rescale: bool = True,
        resblock_type: str = "biggan",
        progressive: str = "output_skip",
        progressive_input: str = "input_skip",
        progressive_combine: str = "sum",
        init_scale: float = 0.0,
        fourier_scale: float = 16.0,
        image_size: int = 256,
        num_channels_in: int = 4,
        num_channels_out: int = 4,
        embedding_type: str = "fourier",
        dropout: float = 0.0,
        centered: bool = False,
        dtype: str = "float32",
        remat: bool = False,
    ):
        super().__init__()
        assert progressive in ("none", "output_skip", "residual")
        assert progressive_input in ("none", "input_skip", "residual")
        assert embedding_type in ("fourier", "positional")
        if resblock_type not in ("ddpm", "biggan"):
            raise ValueError(f"resblock type {resblock_type} unrecognized.")
        combine = progressive_combine.lower()
        self.scale_by_sigma, self.conditional, self.centered = scale_by_sigma, conditional, centered
        self.act = layers.get_act(nonlinearity)
        self.nf = nf
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        self.skip_rescale = skip_rescale
        self.resblock_type = resblock_type
        self.progressive, self.progressive_input = progressive, progressive_input
        self.embedding_type = embedding_type
        self.remat = remat
        self.compute_dtype = torch.bfloat16 if dtype in ("bfloat16", "bf16") else torch.float32

        num_resolutions = len(self.ch_mult)
        all_resolutions = [image_size // (2**i) for i in range(num_resolutions)]
        temb_dim = 4 * nf if conditional else None

        def attn(ch):
            return layers.AttnBlockpp(ch, skip_rescale=skip_rescale, init_scale=init_scale)

        def resnet(in_ch, out_ch, up=False, down=False):
            if resblock_type == "ddpm":
                return layers.ResnetBlockDDPMpp(in_ch, out_ch, temb_dim=temb_dim, act=nonlinearity,
                                                skip_rescale=skip_rescale, init_scale=init_scale)
            return layers.ResnetBlockBigGANpp(
                in_ch, out_ch, temb_dim=temb_dim, act=nonlinearity, up=up, down=down, fir=fir,
                fir_kernel=fir_kernel, skip_rescale=skip_rescale, init_scale=init_scale,
            )

        modules = []
        if embedding_type == "fourier":
            modules.append(layers.GaussianFourierProjection(embedding_size=nf, scale=fourier_scale))
        if conditional:
            emb_dim = 2 * nf if embedding_type == "fourier" else nf
            modules += [layers.Dense(emb_dim, 4 * nf), layers.Dense(4 * nf, 4 * nf)]

        channels = num_channels_in
        if progressive == "output_skip":
            self.pyramid_upsample = layers.Upsample(channels, fir=fir, fir_kernel=fir_kernel)
        if progressive_input == "input_skip":
            self.pyramid_downsample = layers.Downsample(channels, fir=fir, fir_kernel=fir_kernel)

        input_pyramid_ch = channels
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
                if resblock_type == "ddpm":
                    modules.append(layers.Downsample(in_ch, with_conv=resamp_with_conv, fir=fir,
                                                     fir_kernel=fir_kernel))
                else:
                    modules.append(resnet(in_ch, in_ch, down=True))
                if progressive_input == "input_skip":
                    modules.append(layers.Combine(channels, in_ch, method=combine))
                    if combine == "cat":
                        in_ch *= 2
                elif progressive_input == "residual":
                    # residual pyramids always take the conv resampler
                    modules.append(layers.Downsample(input_pyramid_ch, in_ch, with_conv=True, fir=fir,
                                                     fir_kernel=fir_kernel))
                    input_pyramid_ch = in_ch
                hs_c.append(in_ch)

        in_ch = hs_c[-1]
        modules += [resnet(in_ch, in_ch), attn(in_ch), resnet(in_ch, in_ch)]

        pyramid_ch = 0
        for i_level in reversed(range(num_resolutions)):
            for _ in range(num_res_blocks + 1):
                out_ch = nf * self.ch_mult[i_level]
                modules.append(resnet(in_ch + hs_c.pop(), out_ch))
                in_ch = out_ch
            if all_resolutions[i_level] in self.attn_resolutions:
                modules.append(attn(in_ch))
            if progressive == "output_skip":
                modules += [layers.group_norm(in_ch), layers.conv3x3(in_ch, channels, init_scale=init_scale)]
            elif progressive == "residual":
                if i_level == num_resolutions - 1:
                    modules += [layers.group_norm(in_ch), layers.conv3x3(in_ch, in_ch)]
                else:
                    modules.append(layers.Upsample(pyramid_ch, in_ch, with_conv=True, fir=fir,
                                                   fir_kernel=fir_kernel))
                pyramid_ch = in_ch
            if i_level != 0:
                if resblock_type == "ddpm":
                    modules.append(layers.Upsample(in_ch, with_conv=resamp_with_conv, fir=fir,
                                                   fir_kernel=fir_kernel))
                else:
                    modules.append(resnet(in_ch, in_ch, up=True))

        assert not hs_c, "skip-channel bookkeeping mismatch"
        if progressive != "output_skip":
            modules += [layers.group_norm(in_ch), layers.conv3x3(in_ch, channels, init_scale=init_scale)]
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

    def _block(self, module: nn.Module, *args) -> Tensor:
        """A residual or attention block, recomputed in the backward under
        remat (where grad mode is on)."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False)
        return module(*args)

    def _combine_residual(self, pyramid: Tensor, h: Tensor) -> Tensor:
        # the JAX package divides by a numpy float64, which promotes bf16 to f32
        if self.skip_rescale:
            return (pyramid + h).float() / np.sqrt(2.0)
        return pyramid + h

    def forward(self, x: Tensor, time_cond: Tensor) -> Tensor:
        modules = self.all_modules
        act = self.act
        cdtype = self.compute_dtype
        num_resolutions = len(self.ch_mult)
        m_idx = 0

        used_sigmas = time_cond
        if self.embedding_type == "fourier":
            temb = modules[0](torch.log(used_sigmas))
            m_idx += 1
        else:
            temb = layers.get_timestep_embedding(time_cond, self.nf)
        if self.conditional:
            temb = modules[m_idx](temb)
            temb = modules[m_idx + 1](act(temb)).to(cdtype)
            m_idx += 2
        else:
            temb = None

        if not self.centered:
            # the reference keeps the [0, 1] -> [-1, 1] map for spectrograms
            x = 2 * x - 1.0
        x = x.to(cdtype)

        input_pyramid = x if self.progressive_input != "none" else None
        hs = [modules[m_idx](x)]
        m_idx += 1
        for i_level in range(num_resolutions):
            for _ in range(self.num_res_blocks):
                h = self._block(modules[m_idx], hs[-1], temb)
                m_idx += 1
                # audio edit: attend when the *frequency* axis matches
                if h.shape[1] in self.attn_resolutions:
                    assert isinstance(modules[m_idx], layers.AttnBlockpp)
                    h = self._block(modules[m_idx], h)
                    m_idx += 1
                hs.append(h)
            if i_level != num_resolutions - 1:
                if self.resblock_type == "ddpm":
                    h = modules[m_idx](hs[-1])
                else:
                    h = self._block(modules[m_idx], hs[-1], temb)
                m_idx += 1
                if self.progressive_input == "input_skip":
                    input_pyramid = self.pyramid_downsample(input_pyramid)
                    h = modules[m_idx](input_pyramid, h)
                    m_idx += 1
                elif self.progressive_input == "residual":
                    input_pyramid = self._combine_residual(modules[m_idx](input_pyramid), h)
                    h = input_pyramid
                    m_idx += 1
                hs.append(h)

        h = hs[-1]
        h = self._block(modules[m_idx], h, temb)
        h = self._block(modules[m_idx + 1], h)
        h = self._block(modules[m_idx + 2], h, temb)
        m_idx += 3

        pyramid = None
        for i_level in reversed(range(num_resolutions)):
            for _ in range(self.num_res_blocks + 1):
                h = self._block(modules[m_idx], torch.cat([h, hs.pop()], dim=-1), temb)
                m_idx += 1
            if h.shape[1] in self.attn_resolutions:
                assert isinstance(modules[m_idx], layers.AttnBlockpp)
                h = self._block(modules[m_idx], h)
                m_idx += 1
            if self.progressive == "output_skip":
                # GroupNorm statistics in f32, activations back in cdtype
                pyramid_h = modules[m_idx + 1](act(modules[m_idx](h)).to(cdtype))
                m_idx += 2
                if i_level == num_resolutions - 1:
                    pyramid = pyramid_h
                else:
                    pyramid = self.pyramid_upsample(pyramid) + pyramid_h
            elif self.progressive == "residual":
                if i_level == num_resolutions - 1:
                    pyramid = modules[m_idx + 1](act(modules[m_idx](h)).to(cdtype))
                    m_idx += 2
                else:
                    pyramid = self._combine_residual(modules[m_idx](pyramid), h)
                    h = pyramid
                    m_idx += 1
            if i_level != 0:
                if self.resblock_type == "ddpm":
                    h = modules[m_idx](h)
                else:
                    h = self._block(modules[m_idx], h, temb)
                m_idx += 1

        assert not hs, "skip stack must be exhausted"
        if self.progressive == "output_skip":
            h = pyramid
        else:
            # the JAX package gives this conv no dtype: it computes in f32
            h = act(modules[m_idx](h)).to(cdtype)
            h = modules[m_idx + 1](h.float())
            m_idx += 2
        assert m_idx == len(modules), "module walk mismatch"

        # score scaling and output projection in float32
        h = h.float()
        if self.scale_by_sigma:
            h = h / used_sigmas.reshape((-1,) + (1,) * (h.ndim - 1))
        return self.output_layer(h)
