# Frozen copy of prometheus_torch/models/gs_decoder.py at commit 078c4a5; imports
# rewritten to this package, kernel A replaced by plain attention.
"""GSDecoderModel: RGB-D latents + Plücker rays -> pixel-aligned 3D Gaussian
parameters (``prometheus_tpu/models/gs_decoder.py``).

The SD VAE decoder emits 14 gaussian channels per pixel. With the
cross-view DiT (``use_cross_view_dit``, the flagship) its ``conv_in`` takes
``[latents 14, cross-view DiT output 14]`` after ``post_quant_conv`` has
mapped the first 4; without it, ``[rgb latent / VAE_SCALE 4, depth latent
4, raymap 6]`` (the DiT branch does not unscale, as in JAX). With
``use_ema_norm`` EMANorms sit after each non-final upsample conv. The
frozen VAE encoder embeds input views (``encode_image``, scale 0.18215).
``decode_and_render`` chains the decode, ``convert_gaussians`` and
``render_gaussians``.
"""
from __future__ import annotations

import torch
from torch import nn

from .converter import convert_gaussians
from .ray_dit import CrossViewDiTWrapped
from .vae import AutoencoderKL

VAE_SCALE = 0.18215


class GSDecoderModel(nn.Module):
    def __init__(self, latent_channel: int = 4, extra_latent_channel: int = 10,
                 use_cross_view_dit: bool = True, use_ema_norm: bool = True,
                 gaussian_channels_out: int = 14, max_num_images: int = 8,
                 dit_hidden_size: int = 1152, dit_depth: int = 16,
                 dit_num_heads: int = 16, vae_ch: int = 128,
                 vae_ch_mult: tuple = (1, 2, 4, 4)):
        super().__init__()
        self.latent_channel = latent_channel
        self.dit_depth = dit_depth
        lat_total = latent_channel + extra_latent_channel           # 14
        self.vae = AutoencoderKL(
            embed_dim=latent_channel, ch=vae_ch, ch_mult=vae_ch_mult,
            decoder_extra_channels=(lat_total * 2 - latent_channel  # 24
                                    if use_cross_view_dit
                                    else extra_latent_channel),
            decoder_out_ch=gaussian_channels_out, use_ema_norm=use_ema_norm,
            with_encoder=True)
        self.cross_view_dit = CrossViewDiTWrapped(
            latent_channels=lat_total, hidden_size=dit_hidden_size,
            depth=dit_depth, num_heads=dit_num_heads,
            max_num_images=max_num_images) if use_cross_view_dit else None

    def encode_image(self, images: torch.Tensor,
                     noise: torch.Tensor | None = None) -> torch.Tensor:
        """``images (B, N, 3, H, W)`` in [-1, 1] -> latents ``(B, N, 4, H/8,
        W/8)``: the posterior's mode, or ``mean + std * noise`` for a given
        standard-normal ``noise`` of the latents' shape."""
        B, N = images.shape[:2]
        posterior = self.vae.encode(images.reshape((B * N,) + images.shape[2:]))
        z = posterior.mode() if noise is None else posterior.sample(noise)
        z = z * VAE_SCALE
        return z.reshape((B, N) + z.shape[1:])

    def decode_latent(self, latents: torch.Tensor, train: bool = False,
                      view_group=None) -> torch.Tensor:
        """``(B, N, 14, h, w)`` ([rgb latent 4, depth latent 4, raymap 6])
        -> raw gaussian parameters ``(B, N, 14, 8h, 8w)``; ``train`` updates
        the EMANorms. ``view_group``: the N views are this rank's share of
        the scene's views (``CrossViewDiT``'s view sharding; without the
        DiT each view decodes alone)."""
        B, N, C, h, w = latents.shape
        lc = self.latent_channel
        if self.cross_view_dit is None:
            x = latents.reshape(B * N, C, h, w)
            out = self.vae.decode(x[:, :lc] / VAE_SCALE, extra_z=x[:, lc:],
                                  post_conv=True, train=train)
            return out.reshape((B, N) + out.shape[1:])
        refined = self.cross_view_dit(latents, t=1000.0,
                                      view_group=view_group)
        x = torch.cat([latents.to(refined.dtype), refined], dim=2)
        x = x.reshape(B * N, 2 * C, h, w)
        out = self.vae.decode(x[:, :lc], extra_z=x[:, lc:], post_conv=True,
                              train=train)
        return out.reshape((B, N) + out.shape[1:])

