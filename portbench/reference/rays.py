# Frozen copy of prometheus_torch/utils/rays.py at commit 078c4a5; imports
# rewritten to this package, kernel A replaced by plain attention.
"""Per-pixel rays and the Plücker raymap (``prometheus_tpu/utils/rays.py``).

Pixel ``(x + 0.5, y + 0.5)`` maps to the OpenGL camera-space direction
``((x + 0.5 - cx) / fx, -(y + 0.5 - cy) / fy, -1)``, rotated to world by
``c2w[:3, :3]``. ``sample_rays_at`` takes the rays at given flat pixel
indices; ``sample_patch_indices`` draws dilated square patches of them.
"""
from __future__ import annotations

import torch

from .cameras import camera_c2w, camera_intrinsics


def _pixel_dirs(fx, fy, cx, cy, h: int, w: int, uv_offset=None):
    """Camera-space unnormalised directions ``(..., h*w, 3)``."""
    dev = fx.device
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    x = (xs - cx[..., None]) / fx[..., None]
    y = -(ys - cy[..., None]) / fy[..., None]
    if uv_offset is not None:
        # the converter's uv offset is in units of (pixel / c)
        x = x + uv_offset[..., 0] * cx[..., None] / fx[..., None]
        y = y - uv_offset[..., 1] * cy[..., None] / fy[..., None]
    return torch.stack([x, y, -torch.ones_like(x)], dim=-1)


def sample_rays(cameras: torch.Tensor, h: int, w: int, *, uv_offset=None,
                normalize: bool = True):
    """``(rays_o, rays_d)``, each ``(..., h*w, 3)``; ``rays_d`` L2-normalised."""
    c2w = camera_c2w(cameras)
    fx, fy, cx, cy, _, _ = camera_intrinsics(cameras, h=h, w=w)
    dirs = _pixel_dirs(fx, fy, cx, cy, h, w, uv_offset=uv_offset)
    rays_d = torch.einsum("...ij,...nj->...ni", c2w[..., :3, :3], dirs)
    if normalize:
        rays_d = rays_d / torch.clamp_min(
            torch.linalg.norm(rays_d, dim=-1, keepdim=True), 1e-8)
    rays_o = c2w[..., None, :3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def sample_rays_at(cameras: torch.Tensor, inds: torch.Tensor, h: int, w: int,
                   normalize: bool = True):
    """``(rays_o, rays_d)``, each ``(..., N, 3)``, at the flat pixel indices
    ``inds (..., N)`` (row-major over ``h x w``)."""
    c2w = camera_c2w(cameras)
    fx, fy, cx, cy, _, _ = camera_intrinsics(cameras, h=h, w=w)
    xs = (inds % w).to(torch.float32) + 0.5
    ys = torch.div(inds, w, rounding_mode="floor").to(torch.float32) + 0.5
    x = (xs - cx[..., None]) / fx[..., None]
    y = -(ys - cy[..., None]) / fy[..., None]
    dirs = torch.stack([x, y, -torch.ones_like(x)], dim=-1)
    rays_d = torch.einsum("...ij,...nj->...ni", c2w[..., :3, :3], dirs)
    if normalize:
        rays_d = rays_d / torch.clamp_min(
            torch.linalg.norm(rays_d, dim=-1, keepdim=True), 1e-8)
    rays_o = c2w[..., None, :3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def patch_indices(mult: torch.Tensor, u_i: torch.Tensor, u_j: torch.Tensor,
                  batch: int, n: int, p: int, h: int, w: int) -> torch.Tensor:
    """The index arithmetic of ``sample_patch_indices`` on given draws:
    ``batch * n / p^2`` patches, each ``p x p`` pixels ``mult`` apart (int,
    in ``[1, min(h, w) // p]``) from the row and column offsets ``floor(u *
    (size - p mult + mult))`` of the uniforms ``u_i``, ``u_j`` (float32).
    Returns ``(batch, n)`` int64 flat indices."""
    span = lambda size: (size - p * mult + mult).to(torch.float32)
    off_i = torch.floor(u_i.to(torch.float32) * span(h)).to(torch.int64)
    off_j = torch.floor(u_j.to(torch.float32) * span(w)).to(torch.int64)
    ar = torch.arange(p, dtype=torch.int64, device=mult.device)
    ii = ar[None, :] * mult[:, None] + off_i[:, None]              # rows
    jj = ar[None, :] * mult[:, None] + off_j[:, None]              # cols
    return (ii[:, :, None] * w + jj[:, None, :]).reshape(batch, n)


def sample_patch_indices(generator: torch.Generator | None, batch: int,
                         n: int, p: int, h: int, w: int,
                         device=None) -> torch.Tensor:
    """Random dilated-patch pixel indices ``(batch, n)``, ``n % p**2 ==
    0``, drawn from ``generator`` (the reference's patch sampler for
    patchwise rendering losses); ``patch_indices`` holds the arithmetic."""
    if n % (p * p):
        raise ValueError(f"n={n} is not a whole number of {p}x{p} patches")
    num = batch * (n // (p * p))
    dev = generator.device if generator is not None else device
    mult = torch.randint(1, min(h, w) // p + 1, (num,), generator=generator,
                         device=dev)
    u_i = torch.rand(num, generator=generator, device=dev)
    u_j = torch.rand(num, generator=generator, device=dev)
    return patch_indices(mult, u_i, u_j, batch, n, p, h, w)


def embed_rays(rays_o: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """Plücker embedding ``[d, o x d]`` -> ``(..., 6)``."""
    return torch.cat([rays_d, torch.linalg.cross(rays_o, rays_d, dim=-1)],
                     dim=-1)


def raymap(cameras: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Plücker raymap ``(..., 6, h, w)`` (channels first)."""
    rays_o, rays_d = sample_rays(cameras, h, w)
    emb = embed_rays(rays_o, rays_d)
    batch = emb.shape[:-2]
    return torch.movedim(emb.reshape(batch + (h, w, 6)), -1, -3)
