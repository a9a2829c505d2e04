"""Frozen copy of the csort binning of ``prometheus_torch/ops/gaussian/
tiled.py`` (commit 078c4a5): the ``(tile, depth)``-sorted worklist of
``(gaussian, tile)`` instances, emitted in tiers (``_CSORT_TIERS``), one
stable sort of the fused key ``(tile << depth_bits) | quantised depth``.
It defines which pairs a tile capacity keeps; the reference renderer walks
the same lists with a plain compositor.
"""
from __future__ import annotations

import math

import torch

from .projection import ALPHA_CUTOFF, Projected, bbox_extents

DEAD_KEY = 0xFFFFFFFF
_CSORT_TIERS: tuple[tuple[int, int | None], ...] = (
    (4, None), (8, 57344), (16, 24576), (64, 12544), (128, 9216),
    (256, 6144), (512, 2304), (1024, 512))


def _tile_bbox(proj: Projected, tile_size: int, grid_w: int, grid_h: int):
    """Per-gaussian covered-tile bbox ``(x0, x1, y0, y1)``, inclusive."""
    rx, ry = bbox_extents(proj)
    mx, my = proj.mean2d[:, 0], proj.mean2d[:, 1]

    def cell(v, hi):
        return torch.clamp(torch.floor(v / tile_size), 0, hi - 1).to(
            torch.int64)

    return (cell(mx - rx, grid_w), cell(mx + rx, grid_w),
            cell(my - ry, grid_h), cell(my + ry, grid_h))


def _clamped_windows(proj: Projected, tile_size: int, grid_w: int,
                     grid_h: int, max_tiles: tuple[int, int]):
    """Covered-tile windows clamped to ``max_tiles`` centred on the mean.
    Returns ``(ex0, ey0, wx, wy)``."""
    wy_cap, wx_cap = max_tiles
    x0, x1, y0, y1 = _tile_bbox(proj, tile_size, grid_w, grid_h)
    wx = torch.clamp_max(x1 - x0 + 1, wx_cap)
    wy = torch.clamp_max(y1 - y0 + 1, wy_cap)
    cxt = torch.clamp(torch.floor(proj.mean2d[:, 0] / tile_size), 0,
                      grid_w - 1).to(torch.int64)
    cyt = torch.clamp(torch.floor(proj.mean2d[:, 1] / tile_size), 0,
                      grid_h - 1).to(torch.int64)
    ex0 = torch.minimum(torch.maximum(cxt - wx // 2, x0), x1 - wx + 1)
    ey0 = torch.minimum(torch.maximum(cyt - wy // 2, y0), y1 - wy + 1)
    return ex0, ey0, wx, wy


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _rect_min_sigma(mx, my, ca, cb, cc, x0, y0, x1, y1):
    """Minimum of ``0.5 (ca dx^2 + cc dy^2) + cb dx dy`` over the rectangle
    ``[x0, x1] x [y0, y1]`` (d = p - mean): 0 when the mean is inside, else
    the smallest of the four edges' clamped 1-D minima."""
    lx, ux = x0 - mx, x1 - mx
    ly, uy = y0 - my, y1 - my

    def q(dx, dy):
        return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    ca_s = torch.clamp_min(ca, 1e-12)
    cc_s = torch.clamp_min(cc, 1e-12)
    y_l = _clip(-cb * lx / cc_s, ly, uy)
    y_u = _clip(-cb * ux / cc_s, ly, uy)
    x_l = _clip(-cb * ly / ca_s, lx, ux)
    x_u = _clip(-cb * uy / ca_s, lx, ux)
    edge_min = torch.minimum(torch.minimum(q(lx, y_l), q(ux, y_u)),
                             torch.minimum(q(x_l, ly), q(x_u, uy)))
    inside = (lx <= 0) & (ux >= 0) & (ly <= 0) & (uy >= 0)
    return torch.where(inside, torch.zeros_like(edge_min), edge_min)


def _tier_b_eff(tier_b: int | None, n: int) -> int | None:
    """A tier's selection size at scene size ``n`` (sized for 524k)."""
    if tier_b is None:
        return None
    return min(n, max(256, tier_b * n // 524288))


def _tile_bits(n_tiles: int) -> int:
    return max(int(math.ceil(math.log2(n_tiles + 1))), 1)


def _candidate_sorted_instances(proj: Projected, tile_size: int, grid_w: int,
                                grid_h: int, max_tiles: tuple[int, int],
                                opacities: torch.Tensor | None = None):
    """``(sorted_tile, sorted_gauss)`` int64 of length ``sum(B_t * K_t)``.

    An empty scene (``n == 0``) gives empty worklists.
    """
    if proj.mean2d.shape[0] == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=proj.mean2d.device)
        return empty, empty.clone()
    keys, gauss, depth_bits = _candidate_keys(proj, tile_size, grid_w, grid_h,
                                              max_tiles, opacities)
    skey, perm = torch.sort(keys, stable=True)
    return skey >> depth_bits, gauss[perm]


def _candidate_keys(proj: Projected, tile_size: int, grid_w: int,
                    grid_h: int, max_tiles: tuple[int, int],
                    opacities: torch.Tensor | None = None):
    """The unsorted candidates of a non-empty scene: ``(keys, gauss,
    depth_bits)``, the fused keys ``(tile << depth_bits) | depth``
    (``DEAD_KEY`` for a dead candidate) and each candidate's gaussian."""
    n = proj.mean2d.shape[0]
    dev = proj.mean2d.device
    tile_bits = _tile_bits(grid_w * grid_h)
    depth_bits = 32 - tile_bits
    ex0, ey0, wx, wy = _clamped_windows(proj, tile_size, grid_w, grid_h,
                                        max_tiles)
    area = torch.where(proj.valid, wx * wy, torch.zeros_like(wx))
    area_order = torch.sort(-area.to(torch.float32), stable=True).indices

    # top depth_bits of the positive float32 bit pattern, carried through a
    # float32 column exactly as the JAX pack does (it rounds at small grids)
    d = proj.depth.detach().to(torch.float32)
    d = torch.clamp_min(torch.where(torch.isfinite(d), d, torch.zeros_like(d)),
                        0.0)
    depth_q = (d.view(torch.int32).to(torch.int64) >> tile_bits).to(
        torch.float32).to(torch.int64)

    cols = [ex0, ey0, torch.clamp_min(wx, 1), area, depth_q]
    fcols = None if opacities is None else _cull_columns(proj, opacities)
    k_cap = max_tiles[0] * max_tiles[1]
    key_parts, gauss_parts = [], []
    k_lo = 0
    for k_hi, tier_b in _CSORT_TIERS:
        k_hi = min(k_hi, k_cap)
        if k_hi <= k_lo:
            continue
        tier_b = _tier_b_eff(tier_b, n)
        if tier_b is None:
            gidx = torch.arange(n, dtype=torch.int64, device=dev)
        else:
            gidx = area_order[:tier_b]
        r_ex0, r_ey0, r_w, r_area, r_dq = (c[gidx, None] for c in cols)
        k = torch.arange(k_lo, k_hi, dtype=torch.int64, device=dev)[None, :]
        tx = r_ex0 + k % r_w
        ty = r_ey0 + k // r_w
        live = k < r_area
        if fcols is not None:
            live = live & _cull(fcols, gidx[:, None], tx, ty, tile_size)
        key = ((ty * grid_w + tx) << depth_bits) | r_dq
        key_parts.append(torch.where(live, key, torch.full_like(key, DEAD_KEY))
                         .reshape(-1))
        gauss_parts.append(gidx[:, None].expand(tx.shape).reshape(-1))
        k_lo = k_hi
    return torch.cat(key_parts), torch.cat(gauss_parts), depth_bits


def sorted_instances(proj: Projected, tile_size: int, grid_w: int,
                     grid_h: int, max_tiles: tuple[int, int],
                     opacities: torch.Tensor | None = None):
    """``(sorted_tile, sorted_gauss)`` int64, sorted by ``(tile, depth)``
    with every dead entry's tile ``>= grid_w * grid_h`` at the end."""
    return _candidate_sorted_instances(proj, tile_size, grid_w, grid_h,
                                       max_tiles, opacities=opacities)


def _cull_columns(proj: Projected, opacities: torch.Tensor):
    """Per gaussian ``(mx, my, ca, cb, cc, q_cut)`` of the exact per-tile
    cull: alpha can reach the cutoff in a tile iff the least sigma over it
    is ``<= q_cut = log(op / ALPHA_CUTOFF)``."""
    mean, conic = proj.mean2d.detach(), proj.conic.detach()
    op = opacities.detach().to(torch.float32)
    q_cut = torch.log(torch.clamp_min(op, 1e-12) / ALPHA_CUTOFF)
    return (mean[:, 0], mean[:, 1], conic[:, 0], conic[:, 1], conic[:, 2],
            q_cut)


def _safe_depth(proj: Projected) -> torch.Tensor:
    d = proj.depth.detach().to(torch.float32)
    return torch.where(torch.isfinite(d), d, torch.zeros_like(d))


def _cull(cols, gidx, tx, ty, tile_size: int):
    """True where gaussian ``gidx``'s alpha can reach the cutoff in tile
    ``(tx, ty)``."""
    mx, my, ca, cb, cc, qc = (c[gidx] for c in cols)
    ts_f = float(tile_size)
    x0 = tx.to(torch.float32) * ts_f
    y0 = ty.to(torch.float32) * ts_f
    return _rect_min_sigma(mx, my, ca, cb, cc, x0, y0, x0 + ts_f,
                           y0 + ts_f) <= qc
