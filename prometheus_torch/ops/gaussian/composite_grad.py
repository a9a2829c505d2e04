"""The differentiable compositor: kernel B forward, kernel C backward
(``prometheus_tpu/ops/gaussian/pallas_backward.py:196-297``,
``composite_pallas_diff`` and ``composite_tiled_pallas_grad``).

``CompositeFunction`` takes the projected gaussians of ``V`` views at once.
Its forward bins every view once (``bin_views``: the binning that
``PROMETHEUS_BIN_DECODE`` picks, ``sorted_tile_segments``, ``gather_rows``,
outside autograd), composites
all ``V`` views' worklists in one kernel B launch, and saves the
worklists, their gaussian indices, the segment mask, the counts and the
depth and alpha images. Its backward chains the expected-depth division,
packs the upstream gradients per tile, runs kernel C (the plain version on
CPU tensors) and sums the per-instance gradients onto the gaussians with
``index_add_``, the counterpart of JAX's ``segment_sum`` (outside the
Pallas kernel there too). Radii and the valid mask only gate binning: they
get no gradient.
"""
from __future__ import annotations

import torch

from ... import profiling
from .compositor import (composite_tiles_bwd, gather_rows,
                         run_compositor_kernel, sorted_tile_segments)
from .projection import Projected, bbox_extents


def bin_views(proj: Projected, colors: torch.Tensor, opacities: torch.Tensor,
              img_h: int, img_w: int, tile_size: int, capacity: int,
              max_tiles: tuple[int, int]):
    """Bin ``V`` views' projected gaussians (leaves ``(V, N, ...)``) into
    one batch of worklists: ``(data (V * T, 16, K), idx (V * T, K) into the
    ``V * N`` gaussians, in_seg (V * T, K), counts (V * T,))``."""
    V, N = proj.mean2d.shape[:2]
    idx, in_seg, counts = [], [], []
    for v in range(V):
        view = Projected(*(None if f is None else f[v] for f in proj))
        g, s, c = sorted_tile_segments(view, img_h, img_w, tile_size,
                                       capacity, max_tiles,
                                       opacities=opacities[v])
        idx.append(g + v * N)
        in_seg.append(s)
        counts.append(c)
    idx, in_seg, counts = (torch.cat(x) for x in (idx, in_seg, counts))
    flat = Projected(proj.mean2d.reshape(V * N, 2),
                     proj.conic.reshape(V * N, 3), proj.depth.reshape(V * N),
                     None, None)
    data = gather_rows(flat, colors.reshape(V * N, 3),
                       opacities.reshape(V * N), idx, in_seg)
    return data, idx, in_seg, counts


class CompositeFunction(torch.autograd.Function):
    """``(mean2d (V, N, 2), conic (V, N, 3), depth (V, N), radii (V, N, 3),
    validf (V, N), colors (V, N, 3), opacities (V, N))`` -> ``(rgb (V, H, W,
    3), expected_depth (V, H, W), alpha (V, H, W))``, not background-blended.
    ``radii`` holds the isotropic radius and the per-axis extents rx, ry."""

    @staticmethod
    def forward(ctx, mean2d, conic, depth, radii, validf, colors, opacities,
                img_h: int, img_w: int, tile_size: int, capacity: int,
                max_tiles: tuple[int, int]):
        V, N = mean2d.shape[:2]
        proj = Projected(mean2d, conic, depth, radii[..., 0], validf > 0.5,
                         rx=radii[..., 1], ry=radii[..., 2])
        with profiling.span("render.bin"):
            data, idx, in_seg, counts = bin_views(
                proj, colors, opacities, img_h, img_w, tile_size, capacity,
                max_tiles)
        with profiling.span("render.composite"):
            rgb, dep, acc_a = run_compositor_kernel(data, counts, img_h,
                                                    img_w, tile_size)
        ctx.save_for_backward(data, idx, in_seg, counts, dep, acc_a)
        ctx.geometry = (V, N, img_h, img_w, tile_size)
        return rgb, dep, acc_a

    @staticmethod
    def backward(ctx, g_rgb, g_dep, g_alpha):
        data, idx, in_seg, counts, dep, acc_a = ctx.saved_tensors
        V, N, img_h, img_w, ts = ctx.geometry
        # expected depth = acc_d / max(alpha, eps): chain the division
        safe_a = torch.clamp_min(acc_a, 1e-10)
        g_acc_d = g_dep / safe_a
        g_a_total = g_alpha - g_dep * dep / safe_a
        grid_h, grid_w = img_h // ts, img_w // ts

        def tile_pack(img):   # (V, H, W, c) -> (V * tiles, c, P)
            c = img.shape[-1]
            out = img.reshape(V, grid_h, ts, grid_w, ts, c)
            return out.permute(0, 1, 3, 5, 2, 4).reshape(
                V * grid_h * grid_w, c, ts * ts)

        gout = torch.cat([
            tile_pack(g_rgb.to(torch.float32)),
            tile_pack(g_acc_d[..., None].to(torch.float32)),
            tile_pack(g_a_total[..., None].to(torch.float32)),
            g_rgb.new_zeros(V * grid_h * grid_w, 3, ts * ts,
                            dtype=torch.float32),
        ], dim=1).contiguous()
        gdata = composite_tiles_bwd(data, gout, counts, grid_w,
                                    grid_h * grid_w, ts)
        vals = gdata[:, :10, :].transpose(1, 2).reshape(-1, 10)
        vals = torch.where(in_seg.reshape(-1, 1), vals, torch.zeros_like(vals))
        acc = vals.new_zeros(V * N, 10).index_add_(0, idx.reshape(-1), vals)
        acc = acc.reshape(V, N, 10)
        return (acc[..., 0:2], acc[..., 2:5], acc[..., 9], None, None,
                acc[..., 5:8], acc[..., 8], None, None, None, None, None)


def composite_tiled_grad(proj: Projected, colors: torch.Tensor,
                         opacities: torch.Tensor, img_h: int, img_w: int,
                         tile_size: int = 16, capacity: int = 512,
                         max_tiles: tuple[int, int] = (4, 4)):
    """Differentiable compositing of ``V`` views at once (``proj`` leaves,
    ``colors`` and ``opacities`` ``(V, N, ...)``; one kernel launch) ->
    ``(rgb (V, H, W, 3), expected_depth (V, H, W), alpha (V, H, W))``."""
    rx, ry = bbox_extents(proj)
    radii = torch.stack([proj.radius, rx, ry], dim=-1)
    return CompositeFunction.apply(
        proj.mean2d, proj.conic, proj.depth, radii,
        proj.valid.to(torch.float32), colors, opacities, img_h, img_w,
        tile_size, capacity, tuple(max_tiles))
