# Frozen copy of prometheus_torch/ops/gaussian/converter.py at commit 078c4a5; imports
# rewritten to this package, kernel A replaced by plain attention.
"""Per-pixel decoder output -> world-space 3D Gaussians
(``prometheus_tpu/ops/gaussian/converter.py``).

The 14 channels per pixel are ``[features 3, uv_offset 2, depth 1,
opacity 1, scales 3, rotations 4]``; ``xyz = rays_o + depth * rays_d``
along the uv-offset-adjusted, L2-normalised pixel rays. Modes:

- ``mvsplat`` (default): sigmoid depth lerped into [z_near, z_far], sigmoid
  scales lerped into [s_min, s_max], sigmoid colours and opacity;
- ``gslrm``: sigmoid depth lerp, ``exp(s - 2.3)`` scales clipped to 0.3,
  ``sigmoid(o - 2)`` opacity, raw colours;
- ``director3d``: channels pre-scaled by ``_D3D_MULS``, ``depth + 1.85``,
  colours over ``2 SH_C0``, offset sigmoid opacity and exp scales, the
  identity rotation added.
"""
from __future__ import annotations

import math

import torch

from .rays import sample_rays

GAUSSIAN_CHANNELS = (3, 2, 1, 1, 3, 4)
NUM_GAUSSIAN_CHANNELS = sum(GAUSSIAN_CHANNELS)
# director3d: per-channel pre-multipliers, normalised by their largest
_D3D_MULS = tuple(m / 0.05 for m in [0.01] * 5 + [0.05] * 2 + [0.005] * 7)
_D3D_OPACITY_OFFSET = math.log(0.01 / 0.99)       # inverse_sigmoid(0.01)
_D3D_SCALES_OFFSET = math.log(1.0 / 100.0)
SH_C0 = 0.28209479177387814


def convert_gaussians(local_params: torch.Tensor, cameras: torch.Tensor,
                      mode: str = "mvsplat", z_near: float = 0.001,
                      z_far: float = 100.0, s_min: float = 0.001,
                      s_max: float = 1.0):
    """``(B, N, 14, h, w)`` raw params + ``(B, N, 18)`` cameras -> the
    gaussian tuple ``(xyz (B, P, 3), features (B, P, 1, 3),
    opacity (B, P, 1), scales (B, P, 3), rotations (B, P, 4))``, P = N*h*w.
    """
    if mode not in ("mvsplat", "gslrm", "director3d"):
        raise ValueError(f"unsupported gs_convert_mode: {mode}")
    B, N, C, h, w = local_params.shape
    if C != NUM_GAUSSIAN_CHANNELS:
        raise ValueError(f"expected {NUM_GAUSSIAN_CHANNELS} channels, got {C}")
    params = torch.movedim(local_params, 2, -1).to(torch.float32)
    if mode == "director3d":
        params = params * params.new_tensor(_D3D_MULS)
    params = params.reshape(B, N, h * w, C)
    feats, uv, depth, opacity, scales, rots = torch.split(
        params, GAUSSIAN_CHANNELS, dim=-1)
    rays_o, rays_d = sample_rays(cameras.to(torch.float32), h, w,
                                 uv_offset=uv)
    if mode == "director3d":
        depth = depth + 1.85
        feats = feats / (2 * SH_C0)
        opacity = torch.sigmoid(opacity + _D3D_OPACITY_OFFSET)
        scales = torch.exp(scales + _D3D_SCALES_OFFSET)
        rots = rots + rots.new_tensor([1.0, 0.0, 0.0, 0.0])
    else:
        d_ = torch.sigmoid(depth)
        depth = z_near * (1 - d_) + z_far * d_
        if mode == "gslrm":
            opacity = torch.sigmoid(opacity - 2.0)
            scales = torch.clamp(torch.exp(scales - 2.3), 0.0, 0.3)
        else:
            s_ = torch.sigmoid(scales)
            scales = s_min * (1 - s_) + s_max * s_
            feats = torch.sigmoid(feats)
            opacity = torch.sigmoid(opacity)
    rots = rots / torch.clamp_min(torch.linalg.norm(rots, dim=-1, keepdim=True),
                                  1e-8)
    xyz = rays_o + depth * rays_d
    npts = N * h * w
    return (xyz.reshape(B, npts, 3), feats.reshape(B, npts, 1, 3),
            opacity.reshape(B, npts, 1), scales.reshape(B, npts, 3),
            rots.reshape(B, npts, 4))
