# Frozen copy of prometheus_torch/models/ray_dit.py at commit 078c4a5; imports
# rewritten to this package, kernel A replaced by plain attention.
"""Cross-view DiT: the GS decoder's multi-view mixer
(``prometheus_tpu/models/ray_dit.py``).

Tokens of all N views are flattened into one joint attention sequence of
``N * width^2`` tokens (2048 at flagship width: 8 views of 16x16), after
per-view and per-patch sinusoid tables (bases 10000 / 70007) are added.
With a ``view_group`` the N views are this rank's share (global views
``[rank * N, (rank + 1) * N)``, whose rows of the view table it adds), and
every block gathers K and V of every rank's tokens. The
GS decoder wraps it in a stride-2 ``conv_in`` (14 -> 392) and a 2x-upsample
``conv_out`` (392 -> 14).
"""
from __future__ import annotations

import torch
from torch import nn

from .plain import get_rank
from .dit import DiTBlock, FinalLayer, TimestepEmbedder, sinusoid_table
from .layers import StridedDownsampleConv, UpsampleConv


class CrossViewDiT(nn.Module):
    """DiT over patchified multi-view grids. ``(B, N, C, H, W)`` in and out."""

    def __init__(self, in_channels: int = 392, out_channels: int = 392,
                 hidden_size: int = 1152, depth: int = 16, num_heads: int = 16,
                 mlp_ratio: float = 4.0, max_num_images: int = 8,
                 patch_size: int = 1):
        super().__init__()
        self.out_channels = out_channels
        self.hidden_size = hidden_size
        self.depth = depth
        self.max_num_images = max_num_images
        self.patch_size = patch_size
        self.x_embedder = nn.Conv2d(in_channels, hidden_size, patch_size,
                                    stride=patch_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        for i in range(depth):
            self.add_module(f"block_{i}",
                            DiTBlock(hidden_size, num_heads, mlp_ratio))
        self.final_layer = FinalLayer(
            hidden_size, patch_size * patch_size * out_channels)

    def forward(self, x: torch.Tensor, t, view_group=None) -> torch.Tensor:
        B, N, C, H, W = x.shape
        P = self.patch_size
        h, w = H // P, W // P
        dtype = self.x_embedder.weight.dtype
        xe = self.x_embedder(x.reshape(B * N, C, H, W).to(dtype))
        tokens = xe.flatten(2).transpose(1, 2).reshape(B, N, h * w, -1)
        start = 0 if view_group is None else get_rank(view_group) * N
        view_pe = torch.from_numpy(sinusoid_table(
            self.max_num_images, self.hidden_size, 10000.0)[start:start + N])
        patch_pe = torch.from_numpy(sinusoid_table(
            h * w, self.hidden_size, 70007.0))
        pe = (view_pe[None, :, None, :] + patch_pe[None, None, :, :]).to(
            device=x.device, dtype=tokens.dtype)
        tokens = (tokens + pe).reshape(B, N * h * w, self.hidden_size)
        t = torch.as_tensor(t, dtype=torch.float32,
                            device=x.device).expand(B)
        c = self.t_embedder(t)
        for i in range(self.depth):
            tokens = getattr(self, f"block_{i}")(tokens, c, view_group)
        out = self.final_layer(tokens, c)
        out = out.reshape(B * N, h, w, P, P, self.out_channels)
        out = out.permute(0, 5, 1, 3, 2, 4).reshape(B, N, self.out_channels,
                                                    H, W)
        return out


class CrossViewDiTWrapped(nn.Module):
    """``conv_in`` (stride-2 down) -> CrossViewDiT -> ``conv_out`` (2x up):
    ``(B, N, 14, 32, 32)`` latents to a same-shape refinement."""

    def __init__(self, latent_channels: int = 14, dit_channels: int = 392,
                 hidden_size: int = 1152, depth: int = 16, num_heads: int = 16,
                 max_num_images: int = 8):
        super().__init__()
        self.dit_channels = dit_channels
        self.conv_in = StridedDownsampleConv(latent_channels, dit_channels)
        self.dit = CrossViewDiT(dit_channels, dit_channels, hidden_size, depth,
                                num_heads, max_num_images=max_num_images)
        self.conv_out = UpsampleConv(dit_channels, latent_channels)

    def forward(self, latents: torch.Tensor, t=1000.0,
                view_group=None) -> torch.Tensor:
        B, N, C, H, W = latents.shape
        dtype = self.conv_in.conv.weight.dtype
        x = self.conv_in(latents.reshape(B * N, C, H, W).to(dtype))
        x = self.dit(x.reshape(B, N, self.dit_channels, H // 2, W // 2), t,
                     view_group)
        x = self.conv_out(x.reshape(B * N, self.dit_channels, H // 2, W // 2))
        return x.reshape(B, N, -1, H, W)
