"""Tile binning (``prometheus_tpu/ops/gaussian/tiled.py``): the
``(tile, depth)``-sorted worklist of ``(gaussian, tile)`` instances that the
compositors cut into per-tile windows.

Every valid gaussian covers a window of 16x16 tiles (its exact bbox, clamped
to ``max_tiles`` centred on the mean). ``sorted_instances`` is the one
binning entry point; ``PROMETHEUS_BIN_DECODE``, read at each call, picks
how the window tiles are expanded:

- ``csort`` (the default): candidates ``(gaussian, window tile)`` are
  emitted in tiers (``_CSORT_TIERS``): window tiles ``[k_lo, k_hi)`` for the
  ``B`` gaussians with the largest windows (all gaussians in the first
  tier). No instance budget; a splat ranked below a tier's ``B`` loses that
  tier's tiles. One stable sort of the fused key ``(tile << depth_bits) |
  quantised depth`` orders the survivors; dead candidates carry
  ``0xFFFFFFFF`` and sink to the end.
- the slot layout (``scanu``, ``scan``, ``addcumsum``, ``bsearch`` or
  ``fscatter``: the JAX package's slot modes all select it): gaussians are laid out by descending opacity and each owns a
  contiguous slot range (a prefix sum of its window areas) inside a static
  ``s_max`` instance budget (``default_instance_budget``, 6 per gaussian),
  so an overflow drops the least opaque splats whole. A binary search of
  the range ends maps each slot to its gaussian. JAX's four slot decodes
  give the same slots; its ``fscatter`` gives them too unless one of its
  tiers' gaussian caps binds, where it drops those splats' tiles and this
  layout keeps them. Dead slots carry the tile id ``n_tiles``;
  ``sort_tile_instances`` sorts the slots on the same fused key.

With opacities given, an instance survives only where the splat's alpha can
reach the cutoff somewhere in its tile (``_rect_min_sigma``). Both
binnings reproduce the JAX worklists bit for bit: the plans, the float32
depth keys and the stable tie orders; the slot layout's ``tile_id`` at
every slot and ``(depth, gauss)`` at every live slot. Keys are int64 here
(torch has no full uint32 sort); every live key is ``< 2**32``. The prefix sums
are int64, exact where JAX's float32 ones are, which its budget check
(``s_max < 2**24 - 2**11``, ``N < 2**24``) guarantees; the check raises here
too.
"""
from __future__ import annotations

import contextlib
import math
import os

import torch

from ... import profiling
from .projection import ALPHA_CUTOFF, Projected, bbox_extents

DEAD_KEY = 0xFFFFFFFF
# PROMETHEUS_BIN_DECODE's names: csort, then JAX's slot modes, which all
# select the one slot layout here
BIN_DECODES = ("csort", "scanu", "scan", "addcumsum", "bsearch", "fscatter")

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


def bin_decode(mode: str | None = None) -> str:
    """``mode``, or the binning ``PROMETHEUS_BIN_DECODE`` names now (``csort``
    when it is unset). Raises ``ValueError`` on a name outside
    ``BIN_DECODES``."""
    if mode is None:
        mode = os.environ.get("PROMETHEUS_BIN_DECODE", "csort")
    if mode not in BIN_DECODES:
        raise ValueError(f"PROMETHEUS_BIN_DECODE={mode!r}: expected one of "
                         f"{', '.join(BIN_DECODES)}")
    return mode


@contextlib.contextmanager
def bin_decode_env(mode: str):
    """Set ``PROMETHEUS_BIN_DECODE`` to ``mode`` for the ``with`` block and
    restore what it was after."""
    bin_decode(mode)
    before = os.environ.get("PROMETHEUS_BIN_DECODE")
    os.environ["PROMETHEUS_BIN_DECODE"] = mode
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("PROMETHEUS_BIN_DECODE", None)
        else:
            os.environ["PROMETHEUS_BIN_DECODE"] = before


def sorted_instances(proj: Projected, tile_size: int, grid_w: int,
                     grid_h: int, max_tiles: tuple[int, int],
                     s_max: int | None = None,
                     opacities: torch.Tensor | None = None):
    """``(sorted_tile, sorted_gauss)`` int64, sorted by ``(tile, depth)``
    with every dead entry's tile ``>= grid_w * grid_h`` at the end: the
    binning every compositor consumes. ``PROMETHEUS_BIN_DECODE`` (read now)
    picks it: ``csort`` (unset) returns the tiered candidates, a slot mode
    ``s_max`` slots (``None``: ``default_instance_budget(N)``)."""
    if bin_decode() == "csort":
        return _candidate_sorted_instances(proj, tile_size, grid_w, grid_h,
                                           max_tiles, opacities=opacities)
    if s_max is None:
        s_max = default_instance_budget(int(proj.mean2d.shape[0]))
    tile_id, depth, gauss = _tile_instances(
        proj, tile_size, grid_w, grid_h, max_tiles, s_max,
        opacities=opacities)
    return sort_tile_instances(tile_id, depth, gauss, grid_w * grid_h)


def sort_tile_instances(tile_id: torch.Tensor, depth: torch.Tensor,
                        gauss_idx: torch.Tensor, n_tiles: int):
    """Order instances by ``(tile, depth)`` with one stable sort of the
    fused key ``(tile << depth_bits) | (float32 bits of max(depth, 0) >>
    tile_bits)``: positive float32 bit patterns order as their values, so
    only near-equal depths can swap. Returns ``(sorted_tile,
    sorted_gauss)`` int64."""
    tile_bits = _tile_bits(n_tiles)
    depth_bits = 32 - tile_bits
    d = torch.clamp_min(depth.detach().to(torch.float32), 0.0).contiguous()
    db = d.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = (tile_id.to(torch.int64) << depth_bits) | (db >> tile_bits)
    skey, perm = torch.sort(key, stable=True)
    return skey >> depth_bits, gauss_idx.to(torch.int64)[perm]


def _opacity_order(opacities: torch.Tensor | None, n: int, dev):
    """Gaussians by descending opacity (non-finite as 0), ties by index:
    the slot layout's order."""
    if opacities is None:
        return torch.arange(n, dtype=torch.int64, device=dev)
    op = opacities.detach().to(torch.float32)
    op = torch.where(torch.isfinite(op), op, torch.zeros_like(op))
    return torch.sort(-op, stable=True).indices


def _slot_layout(proj: Projected, tile_size: int, grid_w: int, grid_h: int,
                 max_tiles: tuple[int, int], s_max: int,
                 opacities: torch.Tensor | None = None) -> dict:
    """The slot ranges of a non-empty scene: ``order`` (layout position ->
    gaussian), ``starts`` / ``ends`` (each position's slot range of its
    window area, 0 if invalid; int64 prefix sums)
    and the windows ``ex0, ey0, wx`` by gaussian. Raises ``ValueError``
    outside the range JAX's float32 layout is exact in."""
    n = proj.mean2d.shape[0]
    if not (s_max < (1 << 24) - (1 << 11) and n < (1 << 24)):
        raise ValueError(
            f"instance budget {s_max} / N {n} exceed the slot layout's exact "
            "range (s_max < 2**24 - 2**11, N < 2**24); shrink the scene")
    ex0, ey0, wx, wy = _clamped_windows(proj, tile_size, grid_w, grid_h,
                                        max_tiles)
    cover = torch.where(proj.valid, wx * wy, torch.zeros_like(wx))
    order = _opacity_order(opacities, n, proj.mean2d.device)
    cover_o = cover[order]
    ends = torch.cumsum(cover_o, 0)
    return dict(order=order, starts=ends - cover_o, ends=ends, ex0=ex0,
                ey0=ey0, wx=wx)


def _decode_slots(layout: dict, s_max: int) -> torch.Tensor:
    """Slot ``j`` -> the layout position owning it, ``(s_max,)`` int64: the
    first position whose range ends past ``j`` (the last position for the
    slots past every range)."""
    ends = layout["ends"]
    j = torch.arange(s_max, dtype=torch.int64, device=ends.device)
    return torch.clamp_max(torch.searchsorted(ends, j, right=True),
                           ends.shape[0] - 1)


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


def _slot_instances(proj: Projected, tile_size: int, grid_w: int,
                    grid_h: int, layout: dict, p_of_slot: torch.Tensor,
                    s_max: int, opacities: torch.Tensor | None = None):
    """Each slot's ``(tile_id, depth, gauss)`` from its owning position:
    the window tile ``j - start`` in row-major window order, dead
    (``n_tiles``) past the last range and, with opacities, where the splat
    cannot reach the cutoff in the tile."""
    dev = p_of_slot.device
    g = layout["order"][p_of_slot]
    j = torch.arange(s_max, dtype=torch.int64, device=dev)
    l = j - layout["starts"][p_of_slot]
    w_i = torch.clamp_min(layout["wx"], 1)[g]
    ty = layout["ey0"][g] + l // w_i
    tx = layout["ex0"][g] + l % w_i
    ok = j < torch.clamp_max(layout["ends"][-1], s_max)
    if opacities is not None:
        ok = ok & _cull(_cull_columns(proj, opacities), g, tx, ty, tile_size)
    tile_id = torch.where(ok, ty * grid_w + tx,
                          torch.full_like(ty, grid_w * grid_h))
    return tile_id, _safe_depth(proj)[g], g


def _dead_slots(n_tiles: int, s_max: int, dev):
    return (torch.full((s_max,), n_tiles, dtype=torch.int64, device=dev),
            torch.zeros(s_max, dtype=torch.float32, device=dev),
            torch.zeros(s_max, dtype=torch.int64, device=dev))


def _tile_instances(proj: Projected, tile_size: int, grid_w: int,
                    grid_h: int, max_tiles: tuple[int, int], s_max: int,
                    opacities: torch.Tensor | None = None):
    """The exact compact expansion: ``(tile_id (s_max,) int64, depth
    (s_max,) f32, gauss (s_max,) int64)``, one entry a slot, dead slots at
    tile ``grid_w * grid_h``."""
    if proj.mean2d.shape[0] == 0:
        return _dead_slots(grid_w * grid_h, s_max, proj.mean2d.device)
    layout = _slot_layout(proj, tile_size, grid_w, grid_h, max_tiles, s_max,
                          opacities)
    return _slot_instances(proj, tile_size, grid_w, grid_h, layout,
                           _decode_slots(layout, s_max), s_max, opacities)


def default_instance_budget(n: int, factor: int = 6) -> int:
    """Static instance budget of the slot-layout binnings: 6 slots a
    gaussian (the trained-statistics scene needs ~5.1 before the cull)."""
    return max(factor * n, 4096)


def tile_overflow_stats(proj: Projected, tile_size: int, grid_w: int,
                        grid_h: int, max_tiles: tuple[int, int],
                        s_max: int | None = None) -> dict:
    """Diagnostics for the binning's static caps: window clamps, instance
    totals against ``s_max`` (``instances_over_budget``: the slots a slot
    layout lacks) and the csort tier overflow (gaussians ranked below a
    tier's ``B`` lose their tiles in that tier's range).

    ``csort_tier_overflow`` is the JAX package's count: gaussians past each
    tier's listed ``B``. The binning keeps ``_tier_b_eff(B, n)`` gaussians a
    tier, which is below ``B`` under 524,288 gaussians, so that count can
    read 0 while tiles are dropped. ``csort_pairs_dropped`` is exact: the
    (gaussian, window tile) pairs of ``instances_needed`` that no tier
    emits, before the opacity test."""
    x0, x1, y0, y1 = _tile_bbox(proj, tile_size, grid_w, grid_h)
    nx, ny = x1 - x0 + 1, y1 - y0 + 1
    valid = proj.valid
    zero = torch.zeros_like(nx)
    clamped = valid & ((ny > max_tiles[0]) | (nx > max_tiles[1]))
    cover = torch.where(valid, torch.clamp_max(ny, max_tiles[0])
                        * torch.clamp_max(nx, max_tiles[1]), zero)
    total = float(cover.to(torch.float32).sum())
    if s_max is None:
        s_max = default_instance_budget(int(proj.mean2d.shape[0]))

    overflow, k_lo = 0, 0
    for k_hi, tier_b in _CSORT_TIERS:
        if tier_b is not None:
            overflow += max(int((cover > k_lo).sum()) - tier_b, 0)
        k_lo = k_hi

    # the binning's tiers: gaussians ranked by window area past a tier's
    # selection size lose that tier's window tiles [k_lo, k_hi)
    ranked = torch.sort(cover, descending=True).values
    n = int(proj.mean2d.shape[0])
    dropped, k_lo = 0, 0
    for k_hi, tier_b in _CSORT_TIERS:
        k_hi = min(k_hi, max_tiles[0] * max_tiles[1])
        if k_hi <= k_lo:
            continue
        b_eff = _tier_b_eff(tier_b, n)
        if b_eff is not None:
            dropped += int((torch.clamp_max(ranked[b_eff:], k_hi) - k_lo)
                           .clamp_min(0).sum())
        k_lo = k_hi
    return {
        "csort_tier_overflow": overflow,
        "csort_pairs_dropped": dropped,
        "n_valid": int(valid.sum()),
        "n_window_clamped": int(clamped.sum()),
        "instances_needed": total,
        "instance_budget": int(s_max),
        "instances_over_budget": max(total - s_max, 0.0),
        "max_cover_y": int(torch.where(valid, ny, zero).max()) if len(ny) else 0,
        "max_cover_x": int(torch.where(valid, nx, zero).max()) if len(nx) else 0,
    }


def composite_tiled(proj: Projected, colors: torch.Tensor,
                    opacities: torch.Tensor, img_h: int, img_w: int,
                    tile_size: int = 16, tile_capacity: int = 1024,
                    max_tiles_y: int = 4, max_tiles_x: int = 4):
    """Render one view of ``(N, ...)`` projected gaussians: the binning
    (``sorted_instances``), each tile's window of at most
    ``tile_capacity`` instances and the tile compositor (kernel B on a CUDA
    tensor, its plain version on a CPU tensor; 128-instance chunks).

    Returns ``(rgb (H, W, 3), expected_depth (H, W), alpha (H, W))``, rgb
    not background-blended.
    """
    from .compositor import gather_rows, run_compositor_kernel, tile_segments

    if img_h % tile_size or img_w % tile_size:
        raise ValueError(f"{img_h}x{img_w} is not whole {tile_size}px tiles")
    grid_h, grid_w = img_h // tile_size, img_w // tile_size
    with profiling.span("render.bin"):
        sorted_tile, sorted_gauss = sorted_instances(
            proj, tile_size, grid_w, grid_h, (max_tiles_y, max_tiles_x),
            opacities=opacities)
        idx, in_seg, counts = tile_segments(sorted_tile, sorted_gauss,
                                            grid_w * grid_h, tile_capacity)
        data = gather_rows(proj, colors, opacities, idx, in_seg)
    with profiling.span("render.composite"):
        rgb, depth, alpha = run_compositor_kernel(data, counts, img_h, img_w,
                                                  tile_size)
    return rgb[0], depth[0], alpha[0]
