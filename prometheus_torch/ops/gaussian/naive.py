"""Exact per-pixel 3DGS compositing, the ground truth of the render-quality
check (``prometheus_tpu/ops/gaussian/naive.py::composite_exact_pixels``).

Every pixel walks every valid gaussian in depth order: no tile culling, no
capacity truncation, no early stop; only the compositors' alpha cutoffs.
"""
from __future__ import annotations

import torch

from .projection import ALPHA_CUTOFF, MAX_ALPHA, Projected


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
