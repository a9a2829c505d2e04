# Frozen copy of prometheus_torch/models/vae.py at commit 078c4a5; imports
# rewritten to this package, kernel A replaced by plain attention.
"""SD KL-f8 VAE with the GS-decoder ``extra_z`` hack
(``prometheus_tpu/models/vae.py``).

``encode(x)`` runs the encoder (ch 128, ch_mult (1, 2, 4, 4),
``num_res_blocks`` blocks per level, a stride-2 downsample after each
non-final level, a res-attn-res middle) and the 1x1 ``quant_conv`` into a
``DiagonalGaussian`` posterior (built only with ``with_encoder``).
``decode(z, extra_z, post_conv, train)`` runs the 1x1 ``post_quant_conv``,
concatenates the extra conditioning channels, and decodes with
``num_res_blocks + 1`` blocks per level, a res-attn-res middle and
GroupNorm(32, eps 1e-6). ``out_ch`` is 3 for images or 14 for gaussian
parameters; the GS decoder puts an EMANorm after each non-final upsample
conv, which ``train`` updates. NCHW in and out.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (AttnBlock, Downsample, GroupNorm32, ResnetBlock,
                     Upsample, conv3x3)


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4,
                 double_z: bool = True, in_channels: int = 3):
        super().__init__()
        self.conv_in = conv3x3(in_channels, ch)
        self.order = []
        block_in = ch
        for i, mult in enumerate(ch_mult):
            for j in range(num_res_blocks):
                name = f"down_{i}_block_{j}"
                self.add_module(name, ResnetBlock(block_in, ch * mult))
                block_in = ch * mult
                self.order.append(name)
            if i != len(ch_mult) - 1:
                name = f"down_{i}_downsample"
                self.add_module(name, Downsample(block_in))
                self.order.append(name)
        self.mid_block_1 = ResnetBlock(block_in, block_in)
        self.mid_attn_1 = AttnBlock(block_in)
        self.mid_block_2 = ResnetBlock(block_in, block_in)
        self.norm_out = GroupNorm32(block_in)
        self.conv_out = conv3x3(block_in,
                                2 * z_channels if double_z else z_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for name in self.order:
            h = getattr(self, name)(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4,
                 extra_channels: int = 0, out_ch: int = 3,
                 use_ema_norm: bool = False):
        super().__init__()
        block_in = ch * ch_mult[-1]
        self.conv_in = conv3x3(z_channels + extra_channels, block_in)
        self.mid_block_1 = ResnetBlock(block_in, block_in)
        self.mid_attn_1 = AttnBlock(block_in)
        self.mid_block_2 = ResnetBlock(block_in, block_in)
        self.order = []
        for i in reversed(range(len(ch_mult))):
            for j in range(num_res_blocks + 1):
                name = f"up_{i}_block_{j}"
                self.add_module(name, ResnetBlock(block_in, ch * ch_mult[i]))
                block_in = ch * ch_mult[i]
                self.order.append(name)
            if i != 0:
                name = f"up_{i}_upsample"
                self.add_module(name, Upsample(block_in, use_ema_norm))
                self.order.append(name)
        self.norm_out = GroupNorm32(block_in)
        self.conv_out = conv3x3(block_in, out_ch)

    def forward(self, z, train: bool = False):
        h = self.conv_in(z)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        for name in self.order:
            block = getattr(self, name)
            h = block(h, train=train) if isinstance(block, Upsample) else block(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class DiagonalGaussian:
    """Posterior over latents from moments ``(B, 2C, h, w)``; the log
    variance is clipped to [-30, 20]."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = torch.chunk(moments, 2, dim=1)
        self.logvar = torch.clamp(logvar, -30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        """``mean + std * noise`` for a given standard-normal ``noise``."""
        return self.mean + self.std * noise.reshape(self.mean.shape).to(
            self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL divergence to the standard normal, summed per sample:
        ``(B,)``."""
        return 0.5 * torch.sum(
            self.mean ** 2 + torch.exp(self.logvar) - 1.0 - self.logvar,
            dim=(1, 2, 3))


class AutoencoderKL(nn.Module):
    """SD VAE with quant / post-quant 1x1 convs; the encoder half only with
    ``with_encoder``."""

    def __init__(self, embed_dim: int = 4, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                 z_channels: int = 4, decoder_extra_channels: int = 0,
                 decoder_out_ch: int = 3, use_ema_norm: bool = False,
                 with_encoder: bool = False):
        super().__init__()
        if with_encoder:
            self.encoder = Encoder(ch, ch_mult, num_res_blocks, z_channels)
            self.quant_conv = nn.Conv2d(2 * z_channels, 2 * embed_dim, 1)
        self.decoder = Decoder(ch, ch_mult, num_res_blocks, z_channels,
                               decoder_extra_channels, decoder_out_ch,
                               use_ema_norm)
        self.post_quant_conv = nn.Conv2d(embed_dim, z_channels, 1)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        """``x (B, 3, H, W)`` in [-1, 1] -> posterior over ``(B, embed_dim,
        H/8, W/8)`` for ch_mult of length 4."""
        h = self.encoder(x.to(self.quant_conv.weight.dtype))
        return DiagonalGaussian(self.quant_conv(h))

    def decode(self, z: torch.Tensor, extra_z: torch.Tensor | None = None,
               post_conv: bool = True, train: bool = False) -> torch.Tensor:
        """``z (B, embed_dim, h, w)``, ``extra_z (B, E, h, w)`` ->
        ``(B, out_ch, 8h, 8w)`` for ch_mult of length 4."""
        dtype = self.post_quant_conv.weight.dtype
        z = z.to(dtype)
        if post_conv:
            z = self.post_quant_conv(z)
        if extra_z is not None:
            z = torch.cat([z, extra_z.to(dtype)], dim=1)
        return self.decoder(z, train=train)
