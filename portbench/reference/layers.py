# Frozen copy of prometheus_torch/models/layers.py at commit 078c4a5; imports
# rewritten to this package, kernel A replaced by plain attention.
"""Shared building blocks (``prometheus_tpu/models/layers.py``).

NCHW throughout (PyTorch's habit; the JAX package runs NHWC inside its
modules and NCHW at their boundaries). Submodules carry the flax names so
``weights.load_jax_params`` maps a JAX param tree onto them mechanically.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .plain import scaled_dot_product_attention


class GroupNorm32(nn.Module):
    """GroupNorm with float32 statistics whatever the compute type.

    Same arithmetic as the JAX ``_GroupNormCore``: ``var = E[x^2] - E[x]^2``
    clamped at 0, the affine folded into one scale and bias. A channel count
    that 32 does not divide halves the group count until it does (small test
    widths).
    """

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6):
        super().__init__()
        while channels % num_groups:
            num_groups //= 2
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        g = self.num_groups
        xf = x.float().reshape(b, g, -1)
        mean = xf.mean(-1)
        var = torch.clamp_min((xf * xf).mean(-1) - mean * mean, 0.0)
        inv = torch.rsqrt(var + self.eps)                       # (B, G)
        inv_c = inv.repeat_interleave(c // g, dim=1)            # (B, C)
        scale = inv_c * self.weight.float()
        bias = self.bias.float() - mean.repeat_interleave(c // g, dim=1) * scale
        shape = (b, c) + (1,) * (x.dim() - 2)
        y = x.float() * scale.reshape(shape) + bias.reshape(shape)
        return y.to(x.dtype)


def conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding ``(..., dim)``, cos first (LDM / SD-2.1)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class ResnetBlock(nn.Module):
    """VAE residual block: GN-silu-conv twice, 1x1 shortcut on a width change."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = GroupNorm32(cin)
        self.conv1 = conv3x3(cin, cout)
        self.norm2 = GroupNorm32(cout)
        self.conv2 = conv3x3(cout, cout)
        self.nin_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the H*W tokens (VAE mid block); the
    head dim is the channel count (512 at flagship width)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.q = nn.Linear(channels, channels)
        self.k = nn.Linear(channels, channels)
        self.v = nn.Linear(channels, channels)
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.norm(x).flatten(2).transpose(1, 2)            # (B, HW, C)
        q, k, v = (lin(y).reshape(b, h * w, 1, c)
                   for lin in (self.q, self.k, self.v))
        out = scaled_dot_product_attention(q, k, v).reshape(b, h * w, c)
        out = self.proj_out(out)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x (``jax.image.resize(..., 'nearest')`` at an exact 2x)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class EMANorm(nn.Module):
    """EMA magnitude normaliser: ``x / sqrt(ema + 1e-5)``, with the EMA of
    ``mean(x^2)`` kept in a buffer (out of the optimizer's reach).

    With ``train`` the EMA first moves towards the detached input's
    ``mean(x^2)`` in float32 (``lerp(mag, ema, beta)``; a NaN magnitude
    leaves it as it was) and the gain uses the updated value, as the flax
    module does with its mutable ``batch_stats``.
    """

    def __init__(self, beta: float = 0.995):
        super().__init__()
        self.beta = beta
        self.register_buffer("magnitude_ema", torch.ones(()))

    def forward(self, x, train: bool = False):
        if train:
            with torch.no_grad():
                mag = x.detach().float().square().mean()
                ema = self.magnitude_ema
                new = mag + self.beta * (ema - mag)
                ema.copy_(torch.where(torch.isnan(mag), ema, new))
        gain = torch.rsqrt(self.magnitude_ema.float() + 1e-5)
        return (x * gain).to(x.dtype)


class Upsample(nn.Module):
    """Nearest 2x + 3x3 conv (+ EMANorm in the GS decoder)."""

    def __init__(self, channels: int, use_ema_norm: bool = False):
        super().__init__()
        self.conv = conv3x3(channels, channels)
        self.ema_norm = EMANorm() if use_ema_norm else None

    def forward(self, x, train: bool = False):
        x = self.conv(upsample2x(x))
        if self.ema_norm is not None:
            x = self.ema_norm(x, train=train)
        return x


class StridedDownsampleConv(nn.Module):
    """Pad (0, 1) on the bottom and right, then a stride-2 3x3 conv (the GS
    decoder DiT's ``conv_in``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class UpsampleConv(nn.Module):
    """Nearest 2x + channel-changing 3x3 conv (the DiT's ``conv_out``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = conv3x3(cin, cout)

    def forward(self, x):
        return self.conv(upsample2x(x))


class Downsample(StridedDownsampleConv):
    """The VAE encoder's stride-2 downsample: the asymmetric (0, 1) pad and
    a 3x3 conv that keeps the channel count."""

    def __init__(self, channels: int):
        super().__init__(channels, channels)
