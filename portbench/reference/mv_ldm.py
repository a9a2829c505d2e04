# Frozen copy of prometheus_torch/models/mv_ldm.py at commit 078c4a5; imports
# rewritten to this package, kernel A replaced by plain attention.
"""MVLDMModel: the multi-view RGB-D latent diffusion model
(``prometheus_tpu/models/mv_ldm.py``).

Composes the MultiViewUNet denoiser, the SD VAE (encoder and decoder) and
the CLIP text tower. ``encode_image`` takes the posterior's mode (or a
sample for given noise) times ``VAE_SCALE``, in float32. ``denoise``
concatenates each view's low-res Plücker raymap onto the noisy RGB-D
latents, repeats the text embeddings per view, flattens the views into the
U-Net's batch with ``num_frames = N`` (joint cross-view attention), and
returns the first 8 output channels (RGB latent 4 + depth latent 4).
``use_checkpoint`` recomputes the U-Net's blocks in a training backward;
``in_channels`` overrides the U-Net's input width (14 for the ``vanilla``
noise type, which has no view-mask channel; the JAX conv infers it).
"""
from __future__ import annotations

import torch
from torch import nn

from .rays import raymap as make_raymap
from .clip_text import CLIPTextModel
from .unet_mv import MultiViewUNet
from .vae import AutoencoderKL

VAE_SCALE = 0.18215


class MVLDMModel(nn.Module):
    def __init__(self, latent_channel: int = 4, extra_latent_channel: int = 11,
                 image_size: int = 256, model_channels: int = 320,
                 context_dim: int = 1024,
                 disable_3d_attentions: tuple = (1, 1, 0, 0, 0, 0, 0, 0, 0, 0,
                                                 0, 0, 0, 1, 1, 1),
                 channel_mult: tuple = (1, 2, 4, 4), num_res_blocks: int = 2,
                 num_head_channels: int = 64, clip_layers: int = 23,
                 clip_width: int = 1024, vae_ch: int = 128,
                 vae_ch_mult: tuple = (1, 2, 4, 4), use_checkpoint: bool = True,
                 in_channels: int | None = None):
        super().__init__()
        self.image_size, self.context_dim = image_size, context_dim
        self.extra_latent_channel = extra_latent_channel
        self.vae_ch_mult = tuple(vae_ch_mult)
        io_ch = latent_channel + extra_latent_channel        # 15
        self.unet = MultiViewUNet(
            in_channels=io_ch if in_channels is None else in_channels,
            out_channels=io_ch,
            model_channels=model_channels, num_res_blocks=num_res_blocks,
            channel_mult=channel_mult, num_head_channels=num_head_channels,
            context_dim=context_dim,
            disable_3d_attentions=disable_3d_attentions,
            use_checkpoint=use_checkpoint)
        self.vae = AutoencoderKL(embed_dim=latent_channel, ch=vae_ch,
                                 ch_mult=vae_ch_mult, with_encoder=True)
        self.text_encoder = CLIPTextModel(width=clip_width,
                                          num_layers=clip_layers,
                                          num_heads=clip_width // 64)

    @property
    def latent_size(self) -> int:
        return self.image_size // (2 ** (len(self.vae_ch_mult) - 1))

    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        """``(B, 77)`` int ids -> ``(B, 77, context_dim)``."""
        return self.text_encoder(input_ids)

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

    def decode_latent(self, latents: torch.Tensor) -> torch.Tensor:
        """``(B, N, 4, h, w)`` -> images ``(B, N, 3, H, W)``."""
        B, N = latents.shape[:2]
        z = latents.reshape((B * N,) + latents.shape[2:]) / VAE_SCALE
        img = self.vae.decode(z)
        return img.reshape((B, N) + img.shape[1:])

    def denoise(self, latents_noisy: torch.Tensor, text_embeddings: torch.Tensor,
                t: torch.Tensor, cameras: torch.Tensor | None = None,
                num_views: int | None = None,
                text_kv: dict | None = None,
                view_group=None) -> torch.Tensor:
        """``latents_noisy (B, N, C, h, w)``, ``text_embeddings (B, L, D)``,
        ``t (B, N)`` noise conditioning, ``cameras (B, N, 18)`` -> the
        prediction for the first 8 channels ``(B, N, 8, h, w)``.
        ``view_group``: the N views are this rank's share of the scene's
        views, and the U-Net's joint sites span the group."""
        B, N, _, h, w = latents_noisy.shape
        x = latents_noisy
        if cameras is not None:
            rm = make_raymap(cameras, h, w).to(x.dtype)
            x = torch.cat([x, rm], dim=2)
        ctx = text_embeddings[:, None].expand(
            (B, N) + text_embeddings.shape[1:])
        ctx = ctx.reshape((B * N,) + text_embeddings.shape[1:])
        out = self.unet(x.reshape((B * N, -1, h, w)), t.reshape(B * N), ctx,
                        num_frames=num_views if num_views is not None else N,
                        text_kv=text_kv, view_group=view_group)
        return out.reshape(B, N, -1, h, w)[:, :, :8]
