"""Per-tile worklists, the tile compositor (kernel B,
``prometheus_tpu/ops/gaussian/pallas_kernel.py``) and its gradient (kernel
C, ``prometheus_tpu/ops/gaussian/pallas_backward.py::_bwd_kernel``).

``sorted_tile_segments`` cuts the binning's order
(``tiled.sorted_instances``: csort, or the slot layout under
``PROMETHEUS_BIN_DECODE``) into per-tile windows of at most ``capacity``
instances, ``gather_rows`` packs them channel-major as
``(T, 16, K)`` f32 (dead slots get zero opacity), and ``composite_tiles``
composites every tile: ``csrc/composite_fwd.cu`` on a CUDA tensor, the plain
PyTorch version on a CPU tensor. ``composite_tiles_bwd`` maps upstream pixel
gradients to per-instance gradients of the same ``(T, 16, K)`` layout:
``csrc/composite_bwd.cu`` on a CUDA tensor, the plain version on a CPU
tensor. ``run_compositor_kernel`` turns the tile outputs into images;
expected depth ``acc_d / max(alpha, 1e-10)`` is taken here, outside the
kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ...utils.cuda_build import CudaKernel
from .projection import ALPHA_CUTOFF, MAX_ALPHA, Projected
from .tiled import sorted_instances

CHUNK = 128
N_CH = 16
T_EPS = 1e-4
_CH_OP = 8

COMPOSITE_FWD = CudaKernel(
    "composite_fwd.cu", "composite_fwd",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
COMPOSITE_BWD = CudaKernel(
    "composite_bwd.cu", "composite_bwd",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def sorted_tile_segments(proj: Projected, img_h: int, img_w: int,
                         tile_size: int, capacity: int,
                         max_tiles: tuple[int, int], opacities=None):
    """The binning's order -> ``(gauss_idx (T, K), in_seg (T, K), counts
    (T,) i32)``."""
    grid_h, grid_w = img_h // tile_size, img_w // tile_size
    sorted_tile, sorted_gauss = sorted_instances(
        proj, tile_size, grid_w, grid_h, max_tiles, opacities=opacities)
    return tile_segments(sorted_tile, sorted_gauss, grid_w * grid_h,
                         capacity)


def tile_segments(sorted_tile: torch.Tensor, sorted_gauss: torch.Tensor,
                  n_tiles: int, capacity: int):
    """Cut the sorted candidates into each tile's window of at most
    ``capacity`` instances: ``(gauss_idx (T, K), in_seg (T, K), counts (T,)
    i32)``."""
    dev = sorted_tile.device
    r = torch.arange(n_tiles, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(sorted_tile, r)
    ends = torch.searchsorted(sorted_tile, r, right=True)
    counts = torch.clamp_max(ends - starts, capacity).to(torch.int32)
    offs = torch.arange(capacity, dtype=torch.int64, device=dev)
    in_seg = offs[None, :] < counts[:, None]
    # segments are contiguous in the sorted order: K-wide windows
    sg_pad = torch.cat([sorted_gauss, sorted_gauss.new_zeros(capacity)])
    g = sg_pad[starts[:, None] + offs[None, :]]
    return g, in_seg, counts


def gather_rows(proj: Projected, colors, opacities, g, in_seg):
    """Packed per-tile worklists ``(T, 16, K)`` f32, channel-major: mean2d,
    conic, rgb, opacity (0 in dead slots), depth, 6 zero rows."""
    depth = proj.depth
    depth_safe = torch.where(torch.isfinite(depth), depth,
                             torch.zeros_like(depth))
    n = proj.mean2d.shape[0]
    packed = torch.cat([
        proj.mean2d, proj.conic, colors, opacities[:, None],
        depth_safe[:, None], proj.mean2d.new_zeros(n, N_CH - 10),
    ], dim=1).to(torch.float32)
    if n == 0:   # every slot is dead; keep the gather in range
        packed = packed.new_zeros(1, N_CH)
    rows = packed[g]                                          # (T, K, 16)
    rows[:, :, _CH_OP] = torch.where(in_seg, rows[:, :, _CH_OP],
                                     torch.zeros_like(rows[:, :, _CH_OP]))
    return rows.transpose(1, 2).contiguous()                  # (T, 16, K)


def composite_tiles_plain(data: torch.Tensor, counts: torch.Tensor,
                          grid_w: int, tiles_per_view: int,
                          tile_size: int = 16) -> torch.Tensor:
    """The plain version of kernel B: ``(T, 16, K)`` -> ``(T, 8, P)``.

    A loop over 128-instance chunks, vectorised over tiles and pixels, with
    the kernel's stopping rule: a tile stops after a chunk once every
    pixel's transmittance is ``<= T_EPS``. A chunk's weighted sums are
    taken in float64, so the result does not depend on the thread count.
    """
    return composite_tiles_plain_counted(data, counts, grid_w,
                                         tiles_per_view, tile_size)[0]


def composite_tiles_plain_counted(data: torch.Tensor, counts: torch.Tensor,
                                  grid_w: int, tiles_per_view: int,
                                  tile_size: int = 16):
    """``composite_tiles_plain`` plus two int64 ``(T,)`` counts of the
    kernel's data-dependent work, read by the bound in ``chip_smoke.py``:
    ``processed``, the instances each tile walks before it stops, and
    ``kept``, the (pixel, instance) pairs of that walk that pass the alpha
    and sigma cutoffs."""
    n_t, _, cap = data.shape
    p = tile_size * tile_size
    dev = data.device
    px, py = (c[..., None] for c in _pixel_centres(
        n_t, grid_w, tiles_per_view, tile_size, dev))

    rgb = data.new_zeros(n_t, p, 3)
    dep = data.new_zeros(n_t, p)
    acc = data.new_zeros(n_t, p)
    trans = data.new_ones(n_t, p)
    counts = torch.clamp_max(counts.to(torch.int64), cap)
    processed = torch.zeros_like(counts)
    kept = torch.zeros_like(counts)
    active = counts > 0
    for k0 in range(0, cap, CHUNK):
        if not bool(active.any()):
            break
        ids = torch.nonzero(active).squeeze(1)
        blk = data[ids, :, k0:k0 + CHUNK]                      # (A, 16, C)
        c = blk.shape[-1]
        processed[ids] = torch.clamp_max(counts[ids], k0 + c)
        live = (k0 + torch.arange(c, device=dev))[None, :] < counts[ids, None]
        dx = px[ids] - blk[:, None, 0, :]                      # (A, P, C)
        dy = py[ids] - blk[:, None, 1, :]
        sigma = 0.5 * (blk[:, None, 2, :] * dx * dx
                       + blk[:, None, 4, :] * dy * dy) \
            + blk[:, None, 3, :] * dx * dy
        alpha = torch.clamp_max(
            blk[:, None, _CH_OP, :] * torch.exp(-torch.clamp_max(sigma, 30.0)),
            MAX_ALPHA)
        keep = (alpha >= ALPHA_CUTOFF) & (sigma >= 0) & live[:, None, :]
        kept[ids] += keep.sum((1, 2))
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
        one_m = 1.0 - alpha
        t_in = torch.cumprod(torch.cat([torch.ones_like(one_m[..., :1]),
                                        one_m[..., :-1]], dim=-1), dim=-1)
        # the chunk's sums in float64, elementwise (no BLAS, whose blocking
        # and code path vary with the thread count and the buffers'
        # alignment): the result does not depend on how the sum is split
        w = (alpha * t_in * trans[ids, :, None]).double()
        rgb[ids] += torch.stack([(w * blk[:, None, 5 + c, :].double()).sum(-1)
                                 for c in range(3)], dim=-1).float()
        dep[ids] += (w * blk[:, None, 9, :].double()).sum(-1).float()
        acc[ids] += w.sum(-1).float()
        trans[ids] = trans[ids] * t_in[..., -1] * one_m[..., -1]
        more = (k0 + CHUNK < counts[ids]) & (trans[ids].amax(-1) > T_EPS)
        active[ids] = more
    out = torch.cat([rgb, dep[..., None], acc[..., None],
                     data.new_zeros(n_t, p, 3)], dim=-1)
    return out.transpose(1, 2).contiguous(), processed, kept


def composite_tiles(data: torch.Tensor, counts: torch.Tensor, grid_w: int,
                    tiles_per_view: int, tile_size: int = 16) -> torch.Tensor:
    """Kernel B on a CUDA tensor, the plain version on a CPU tensor.

    ``data (T, 16, K)`` f32, ``counts (T,)`` i32 -> ``(T, 8, tile_size^2)``
    f32: rgb, accumulated depth, accumulated alpha, three zero rows.
    """
    if data.device.type == "cpu":
        return composite_tiles_plain(data, counts, grid_w, tiles_per_view,
                                     tile_size)
    if data.device.type != "cuda":
        raise ValueError(f"composite_tiles: unsupported device {data.device}")
    n_t = data.shape[0]
    if (data.dim() != 3 or data.shape[1] != N_CH or data.dtype != torch.float32
            or not data.is_contiguous()):
        raise ValueError("composite_tiles: data must be a contiguous "
                         f"(T, {N_CH}, K) float32 tensor, got "
                         f"{tuple(data.shape)} {data.dtype}")
    if (counts.shape != (n_t,) or counts.dtype != torch.int32
            or counts.device != data.device or not counts.is_contiguous()):
        raise ValueError("composite_tiles: counts must be a contiguous (T,) "
                         "int32 tensor on the data's device")
    if tile_size != 16:
        raise ValueError("composite_tiles: the kernel composites 16x16 tiles")
    out = torch.empty(n_t, 8, tile_size * tile_size, device=data.device,
                      dtype=torch.float32)
    if n_t == 0:
        return out
    COMPOSITE_FWD.launch(data.data_ptr(), counts.data_ptr(), out.data_ptr(),
                         n_t, data.shape[2], grid_w, tiles_per_view,
                         torch.cuda.current_stream(data.device).cuda_stream)
    return out


def _pixel_centres(n_t: int, grid_w: int, tiles_per_view: int,
                   tile_size: int, dev):
    """``(px, py)`` ``(T, P)`` float32 pixel centres of every tile."""
    local = torch.arange(n_t, device=dev) % tiles_per_view
    pix = torch.arange(tile_size * tile_size, device=dev)
    px = ((local % grid_w) * tile_size)[:, None] + pix % tile_size + 0.5
    py = ((local // grid_w) * tile_size)[:, None] + pix // tile_size + 0.5
    return px.to(torch.float32), py.to(torch.float32)


def composite_tiles_bwd_plain(data: torch.Tensor, gout: torch.Tensor,
                              counts: torch.Tensor, grid_w: int,
                              tiles_per_view: int, tile_size: int = 16):
    """The plain version of kernel C: ``data (T, 16, K)`` and the upstream
    pixel gradients ``gout (T, 8, P)`` (rows gC r, g, b, gZ, gA, 0, 0, 0)
    -> per-instance gradients ``gdata (T, 16, K)``."""
    return composite_tiles_bwd_plain_counted(data, gout, counts, grid_w,
                                             tiles_per_view, tile_size)[0]


def composite_tiles_bwd_plain_counted(data: torch.Tensor, gout: torch.Tensor,
                                      counts: torch.Tensor, grid_w: int,
                                      tiles_per_view: int,
                                      tile_size: int = 16,
                                      tile_batch: int = 64):
    """``composite_tiles_bwd_plain`` plus two int64 ``(T,)`` counts read by
    the bound in ``chip_smoke.py``: ``walked``, the instance slots each tile
    walks (every slot of the ``ceil(count / 128)`` chunks its count reaches,
    with no early stop), and ``kept``, the (pixel, instance) pairs of that
    walk with a nonzero alpha.

    The math of ``pallas_backward.py::_bwd_kernel`` on whole worklists:
    exclusive transmittance products, u = c gC + z gZ + gA, suffix sums
    S_i = sum_{j > i} u_j w_j, and on live pairs (alpha_raw in
    [1/255, 0.999), sigma >= 0) dalpha = u T - S / max(1 - alpha, 1e-3),
    chained to opacity, mean2d and conic; color and depth get gC w, gZ w.
    Tiles go ``tile_batch`` at a time to bound the ``(tiles, P, K)``
    temporaries.
    """
    n_t, _, cap = data.shape
    dev = data.device
    px_all, py_all = _pixel_centres(n_t, grid_w, tiles_per_view, tile_size,
                                    dev)
    counts = torch.clamp_max(counts.to(torch.int64), cap)
    walked = (counts + CHUNK - 1) // CHUNK * CHUNK
    kept = torch.zeros_like(counts)
    gdata = data.new_zeros(n_t, N_CH, cap)
    for t0 in range(0, n_t, tile_batch):
        sl = slice(t0, min(t0 + tile_batch, n_t))
        kw = int(walked[sl].max()) if n_t else 0
        if kw == 0:
            continue
        blk = data[sl, :, :kw]                                  # (A, 16, C)
        walk = torch.arange(kw, device=dev)[None, :] < walked[sl, None]
        px, py = px_all[sl, :, None], py_all[sl, :, None]      # (A, P, 1)
        row = lambda r: blk[:, None, r, :]                     # (A, 1, C)
        dx, dy = px - row(0), py - row(1)
        sigma = 0.5 * (row(2) * dx * dx + row(4) * dy * dy) + row(3) * dx * dy
        raw = row(_CH_OP) * torch.exp(-torch.clamp_max(sigma, 30.0))
        ok = (raw >= ALPHA_CUTOFF) & (sigma >= 0) & walk[:, None, :]
        alpha = torch.where(ok, torch.clamp_max(raw, MAX_ALPHA),
                            torch.zeros_like(raw))
        live = ok & (raw < MAX_ALPHA)
        kept[sl] = ok.sum((1, 2))
        one_m = 1.0 - alpha
        t_in = torch.cumprod(torch.cat([torch.ones_like(one_m[..., :1]),
                                        one_m[..., :-1]], dim=-1), dim=-1)
        w = alpha * t_in
        g = gout[sl].transpose(1, 2)                           # (A, P, 8)
        g_rgb, g_z, g_a = g[..., 0:3], g[..., 3:4], g[..., 4:5]
        u = torch.einsum("apk,akc->apc", g_rgb, blk[:, 5:8]) \
            + g_z * row(9) + g_a
        uw = u * w
        rev = uw.flip(-1).cumsum(-1).flip(-1)
        suffix = torch.cat([rev[..., 1:], torch.zeros_like(rev[..., :1])], -1)
        d_alpha = torch.where(
            live, u * t_in - suffix / torch.clamp_min(one_m, 1e-3),
            torch.zeros_like(u))
        d_sigma = -alpha * d_alpha
        op = row(_CH_OP)
        d_op = (d_alpha * torch.where(op > 0, alpha / torch.clamp_min(op, 1e-8),
                                      torch.zeros_like(alpha))).sum(1)
        a_c, b_c, c_c = row(2), row(3), row(4)
        grads = torch.stack([
            (d_sigma * -(a_c * dx + b_c * dy)).sum(1),
            (d_sigma * -(c_c * dy + b_c * dx)).sum(1),
            (d_sigma * 0.5 * dx * dx).sum(1),
            (d_sigma * dx * dy).sum(1),
            (d_sigma * 0.5 * dy * dy).sum(1),
            *torch.einsum("apk,apc->akc", g_rgb, w).unbind(1),
            d_op,
            torch.einsum("apk,apc->akc", g_z, w)[:, 0],
        ], dim=1)                                               # (A, 10, C)
        gdata[sl, :10, :kw] = torch.where(walk[:, None, :], grads,
                                          torch.zeros_like(grads))
    return gdata, walked, kept


def composite_tiles_bwd(data: torch.Tensor, gout: torch.Tensor,
                        counts: torch.Tensor, grid_w: int,
                        tiles_per_view: int,
                        tile_size: int = 16) -> torch.Tensor:
    """Kernel C on a CUDA tensor, the plain version on a CPU tensor.

    ``data (T, 16, K)`` f32 with ``K % 128 == 0``, ``gout (T, 8,
    tile_size^2)`` f32, ``counts (T,)`` i32 -> ``gdata (T, 16, K)`` f32.
    """
    if data.device.type == "cpu":
        return composite_tiles_bwd_plain(data, gout, counts, grid_w,
                                         tiles_per_view, tile_size)
    if data.device.type != "cuda":
        raise ValueError(
            f"composite_tiles_bwd: unsupported device {data.device}")
    n_t = data.shape[0]
    if (data.dim() != 3 or data.shape[1] != N_CH or data.dtype != torch.float32
            or not data.is_contiguous() or data.shape[2] % CHUNK):
        raise ValueError("composite_tiles_bwd: data must be a contiguous "
                         f"(T, {N_CH}, K) float32 tensor with K % {CHUNK} == "
                         f"0, got {tuple(data.shape)} {data.dtype}")
    if (gout.shape != (n_t, 8, tile_size * tile_size)
            or gout.dtype != torch.float32 or gout.device != data.device
            or not gout.is_contiguous()):
        raise ValueError("composite_tiles_bwd: gout must be a contiguous "
                         f"({n_t}, 8, {tile_size ** 2}) float32 tensor on "
                         "the data's device")
    if (counts.shape != (n_t,) or counts.dtype != torch.int32
            or counts.device != data.device or not counts.is_contiguous()):
        raise ValueError("composite_tiles_bwd: counts must be a contiguous "
                         "(T,) int32 tensor on the data's device")
    if tile_size != 16:
        raise ValueError("composite_tiles_bwd: the kernel takes 16x16 tiles")
    gdata = torch.empty_like(data)
    if n_t == 0:
        return gdata
    COMPOSITE_BWD.launch(data.data_ptr(), gout.data_ptr(), counts.data_ptr(),
                         gdata.data_ptr(), n_t, data.shape[2], grid_w,
                         tiles_per_view,
                         torch.cuda.current_stream(data.device).cuda_stream)
    return gdata


def run_compositor_kernel(data: torch.Tensor, counts: torch.Tensor,
                          img_h: int, img_w: int, tile_size: int = 16):
    """Composite ``V`` views' worklists (``V * tiles`` rows, view-major).

    Returns ``(rgb (V, H, W, 3), expected_depth (V, H, W),
    alpha (V, H, W))``.
    """
    grid_h, grid_w = img_h // tile_size, img_w // tile_size
    n_tiles = grid_h * grid_w
    out = composite_tiles(data, counts, grid_w, n_tiles, tile_size)
    v = out.shape[0] // n_tiles
    out = out.reshape(v, grid_h, grid_w, 8, tile_size, tile_size)
    out = out.permute(0, 3, 1, 4, 2, 5).reshape(v, 8, img_h, img_w)
    rgb = out[:, :3].permute(0, 2, 3, 1)
    acc_a = out[:, 4]
    dep = out[:, 3] / torch.clamp_min(acc_a, 1e-10)
    return rgb, dep, acc_a
