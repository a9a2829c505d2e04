# Frozen copy of prometheus_torch/models/gm_ldm.py at commit 078c4a5; imports
# rewritten to this package, kernel A replaced by plain attention.
"""GMLDMModel: the legacy single-model Director3D-style variant
(``prometheus_tpu/models/gm_ldm.py``).

One latent diffusion model: a ``MultiViewUNet`` denoises RGB latents
concatenated with each view's Plücker raymap, and a gaussian-headed VAE
decoder turns latents (plus the raymap as ``extra_z``) directly into 14
gaussian channels per pixel, converted in ``director3d`` mode. There is no
separate stage-1 decoder.

flax infers a conv's input channels from the data; a torch conv fixes them
here. The U-Net's and the VAE decoder's inputs are the latents plus the
6-channel raymap the system concatenates (``RAYMAP_CHANNELS``), whatever
``extra_latent_channel`` says; the U-Net's output width is ``latent_channel
+ extra_latent_channel`` as in JAX.
"""
from __future__ import annotations

import torch
from torch import nn

from .converter import convert_gaussians
from .unet_mv import MultiViewUNet
from .vae import AutoencoderKL

VAE_SCALE = 0.18215
RAYMAP_CHANNELS = 6


class GMLDMModel(nn.Module):
    def __init__(self, latent_channel: int = 4, extra_latent_channel: int = 6,
                 image_size: int = 256, model_channels: int = 320,
                 context_dim: int = 1024, gaussian_channels_out: int = 14,
                 use_checkpoint: bool = True,
                 channel_mult: tuple = (1, 2, 4, 4), num_res_blocks: int = 2,
                 num_head_channels: int = 64, vae_ch: int = 128,
                 vae_ch_mult: tuple = (1, 2, 4, 4)):
        super().__init__()
        self.latent_channel = latent_channel
        self.vae_ch_mult = tuple(vae_ch_mult)
        self.unet = MultiViewUNet(
            in_channels=latent_channel + RAYMAP_CHANNELS,
            out_channels=latent_channel + extra_latent_channel,
            model_channels=model_channels, num_res_blocks=num_res_blocks,
            channel_mult=channel_mult, num_head_channels=num_head_channels,
            context_dim=context_dim, use_checkpoint=use_checkpoint)
        self.vae = AutoencoderKL(
            embed_dim=latent_channel, ch=vae_ch, ch_mult=vae_ch_mult,
            decoder_extra_channels=RAYMAP_CHANNELS,
            decoder_out_ch=gaussian_channels_out, with_encoder=True)

    def encode_image(self, images: torch.Tensor,
                     noise: torch.Tensor | None = None) -> torch.Tensor:
        """``images (B, N, 3, H, W)`` in [-1, 1] -> float32 latents ``(B, N,
        4, h, w)``: the posterior's mode, or ``mean + std * noise`` for a
        given standard-normal ``noise``, times ``VAE_SCALE``."""
        B, N = images.shape[:2]
        post = self.vae.encode(images.reshape((B * N,) + images.shape[2:]))
        z = (post.mode() if noise is None else post.sample(noise)).float()
        z = z * VAE_SCALE
        return z.reshape((B, N) + z.shape[1:])

    def denoise(self, latents_noisy: torch.Tensor,
                text_embeddings: torch.Tensor, t: torch.Tensor,
                num_views: int | None = None) -> torch.Tensor:
        """``latents_noisy (B, N, 4 + 6, h, w)`` (the raymap included),
        ``text_embeddings (B, L, D)`` repeated over the views, ``t (B, N)``
        -> the 4-channel prediction ``(B, N, 4, h, w)``; the views attend
        jointly (``num_frames = N``)."""
        B, N, _, h, w = latents_noisy.shape
        ctx = text_embeddings[:, None].expand(
            (B, N) + text_embeddings.shape[1:])
        ctx = ctx.reshape((B * N,) + text_embeddings.shape[1:])
        out = self.unet(latents_noisy.reshape((B * N, -1, h, w)),
                        t.reshape(B * N), ctx,
                        num_frames=num_views if num_views is not None else N)
        return out.reshape(B, N, -1, h, w)[:, :, :self.latent_channel]

    def decode_raw(self, latents: torch.Tensor,
                   raymap: torch.Tensor) -> torch.Tensor:
        """RGB latents ``(B, N, 4, h, w)`` + raymap ``(B, N, 6, h, w)`` ->
        raw gaussian parameters ``(B, N, 14, 8h, 8w)``."""
        B, N = latents.shape[:2]
        z = latents.reshape((B * N,) + latents.shape[2:]) / VAE_SCALE
        extra = raymap.reshape((B * N,) + raymap.shape[2:])
        raw = self.vae.decode(z, extra_z=extra)
        return raw.reshape((B, N) + raw.shape[1:])

    def decode_gaussians(self, latents: torch.Tensor, raymap: torch.Tensor,
                         cameras: torch.Tensor):
        """``decode_raw`` -> the gaussian tuple (``director3d``
        activations)."""
        return convert_gaussians(self.decode_raw(latents, raymap), cameras,
                                 mode="director3d")
