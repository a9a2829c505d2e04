"""Exact per-pixel 3DGS compositing (``prometheus_tpu/ops/gaussian/
naive.py``): ``composite_exact_pixels``, the ground truth of the
render-quality check, and ``composite_naive``, the dense O(HW N) reference.

Every pixel walks every valid gaussian in depth order: no capacity
truncation, no early stop; only the compositors' alpha cutoffs (and, in
``composite_naive`` with a ``tile_size``, the binning's tile bbox cull).
"""
from __future__ import annotations

import torch

from .projection import ALPHA_CUTOFF, MAX_ALPHA, Projected, bbox_extents


def composite_exact_pixels(proj: Projected, colors: torch.Tensor,
                           opacities: torch.Tensor, px: torch.Tensor,
                           chunk: int = 4096):
    """Front-to-back compositing at pixel centres ``px (P, 2)`` (x + 0.5,
    y + 0.5) of the ``(N, ...)`` projected gaussians, ``colors (N, 3)`` and
    ``opacities (N,)``, in depth-sorted chunks of ``chunk`` gaussians that
    carry each pixel's transmittance, so memory is O(P * chunk).

    Returns ``(rgb (P, 3), expected_depth (P,), alpha (P,))``, rgb without
    the background blend.
    """
    inf = torch.full_like(proj.depth, float("inf"))
    order = torch.argsort(torch.where(proj.valid, proj.depth, inf),
                          stable=True)
    valid = proj.valid[order]
    mean2d, conic, cols, opac = (a[order] for a in (proj.mean2d, proj.conic,
                                                    colors, opacities))
    d_sorted = proj.depth[order]
    depth = torch.where(torch.isfinite(d_sorted), d_sorted,
                        torch.zeros_like(d_sorted))
    P = px.shape[0]
    rgb = px.new_zeros(P, 3)
    dep = px.new_zeros(P)
    trans = px.new_ones(P)
    for c0 in range(0, mean2d.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        m2, con = mean2d[sl], conic[sl]
        d = px[:, None, :] - m2[None, :, :]                     # (P, C, 2)
        sigma = 0.5 * (con[None, :, 0] * d[..., 0] ** 2
                       + con[None, :, 2] * d[..., 1] ** 2) \
            + con[None, :, 1] * d[..., 0] * d[..., 1]
        alpha = torch.clamp_max(opac[sl][None, :] * torch.exp(-sigma),
                                MAX_ALPHA)
        keep = valid[sl][None, :] & (alpha >= ALPHA_CUTOFF) & (sigma >= 0)
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
        one_m = 1.0 - alpha
        t_in = torch.cat([torch.ones_like(alpha[:, :1]),
                          torch.cumprod(one_m[:, :-1], dim=1)], dim=1)
        w = alpha * t_in * trans[:, None]
        rgb = rgb + w @ cols[sl]
        dep = dep + w @ depth[sl]
        trans = trans * t_in[:, -1] * one_m[:, -1]
    acc_alpha = 1.0 - trans
    return rgb, dep / torch.clamp_min(acc_alpha, 1e-10), acc_alpha


def composite_naive(proj: Projected, colors: torch.Tensor,
                    opacities: torch.Tensor, img_h: int, img_w: int,
                    tile_size: int | None = None):
    """Front-to-back compositing of every pixel over all ``N`` gaussians at
    once (``(H W, N)`` temporaries: small scenes only). With ``tile_size``
    a gaussian reaches a pixel only when the pixel's tile meets its
    bounding box, the production binning's cull.

    Returns ``(rgb (H, W, 3), expected_depth (H, W), alpha (H, W))``, rgb
    without the background blend.
    """
    order = torch.argsort(proj.depth, stable=True)
    mean2d, conic, depth, valid, cols, opac = (
        a[order] for a in (proj.mean2d, proj.conic, proj.depth, proj.valid,
                           colors, opacities))
    dev = mean2d.device
    ys, xs = torch.meshgrid(
        torch.arange(img_h, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(img_w, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij")
    px = torch.stack([xs, ys], dim=-1).reshape(-1, 2)              # (P, 2)
    d = px[:, None, :] - mean2d[None, :, :]                        # (P, N, 2)
    sigma = 0.5 * (conic[None, :, 0] * d[..., 0] ** 2
                   + conic[None, :, 2] * d[..., 1] ** 2) \
        + conic[None, :, 1] * d[..., 0] * d[..., 1]
    alpha = torch.clamp_max(opac[None, :] * torch.exp(-sigma), MAX_ALPHA)
    keep = valid[None, :] & (alpha >= ALPHA_CUTOFF) & (sigma >= 0)
    if tile_size is not None:
        rx, ry = (e[order] for e in bbox_extents(proj))
        tx = torch.floor((px[:, 0] - 0.5) / tile_size)[:, None]
        ty = torch.floor((px[:, 1] - 0.5) / tile_size)[:, None]
        gx0 = torch.floor((mean2d[:, 0] - rx) / tile_size)[None]
        gx1 = torch.floor((mean2d[:, 0] + rx) / tile_size)[None]
        gy0 = torch.floor((mean2d[:, 1] - ry) / tile_size)[None]
        gy1 = torch.floor((mean2d[:, 1] + ry) / tile_size)[None]
        keep = keep & (tx >= gx0) & (tx <= gx1) & (ty >= gy0) & (ty <= gy1)
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    # transmittance before each gaussian: the exclusive product of 1 - alpha
    one_m = 1.0 - alpha
    trans = torch.cat([torch.ones_like(alpha[:, :1]),
                       torch.cumprod(one_m[:, :-1], dim=1)], dim=1)
    w = alpha * trans
    depth_safe = torch.where(torch.isfinite(depth), depth,
                             torch.zeros_like(depth))
    rgb = w @ cols
    acc_alpha = w.sum(-1)
    exp_depth = (w @ depth_safe) / torch.clamp_min(acc_alpha, 1e-10)
    return (rgb.reshape(img_h, img_w, 3), exp_depth.reshape(img_h, img_w),
            acc_alpha.reshape(img_h, img_w))
