"""The reference renderer: the port's render contract with a plain
compositor in place of kernel B.

Projection (``projection.py``) and the csort worklists (``tiled.py``) are
frozen copies (commit 078c4a5), so a tile capacity keeps the same pairs as
in the program; the tiles are then composited by the plain version of
kernel B (``prometheus_torch/ops/gaussian/compositor.py::
composite_tiles_plain_counted``, frozen), one view at a time. With
``dtype=torch.bfloat16`` every step runs in bf16: the control of a float32
render.
"""
from __future__ import annotations

import torch

from .cameras import camera_intrinsics
from .projection import (ALPHA_CUTOFF, MAX_ALPHA, Projected, bbox_extents,
                         project_gaussians, w2c_from_camera_vector)
from .tiled import sorted_instances

CHUNK = 128
N_CH = 16
T_EPS = 1e-4
_CH_OP = 8
BACKGROUND = (1.0, 1.0, 1.0)


def project_view(camera, xyz, scales, rotations, opacity, h: int, w: int,
                 near: float = 0.01) -> Projected:
    """The camera's matrices come from its float32 vector, then take the
    gaussians' dtype."""
    camera = camera.float()
    dt = xyz.dtype
    fx, fy, cx, cy, _, _ = (v.to(dt) for v in
                            camera_intrinsics(camera, h=h, w=w))
    return project_gaussians(xyz, scales, rotations,
                             w2c_from_camera_vector(camera).to(dt), fx, fy,
                             cx, cy, h, w, near=near, opacities=opacity)


def tile_segments(sorted_tile, sorted_gauss, n_tiles: int, capacity: int):
    dev = sorted_tile.device
    r = torch.arange(n_tiles, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(sorted_tile, r)
    ends = torch.searchsorted(sorted_tile, r, right=True)
    counts = torch.clamp_max(ends - starts, capacity)
    offs = torch.arange(capacity, dtype=torch.int64, device=dev)
    in_seg = offs[None, :] < counts[:, None]
    sg_pad = torch.cat([sorted_gauss, sorted_gauss.new_zeros(capacity)])
    return sg_pad[starts[:, None] + offs[None, :]], in_seg, counts


def gather_rows(proj: Projected, colors, opacities, g, in_seg):
    depth = proj.depth
    depth_safe = torch.where(torch.isfinite(depth), depth,
                             torch.zeros_like(depth))
    n = proj.mean2d.shape[0]
    packed = torch.cat([proj.mean2d, proj.conic, colors, opacities[:, None],
                        depth_safe[:, None],
                        proj.mean2d.new_zeros(n, N_CH - 10)], dim=1)
    rows = packed[g]                                          # (T, K, 16)
    rows[:, :, _CH_OP] = torch.where(in_seg, rows[:, :, _CH_OP],
                                     torch.zeros_like(rows[:, :, _CH_OP]))
    return rows.transpose(1, 2).contiguous()                  # (T, 16, K)


def pixel_centres(n_t: int, grid_w: int, tile_size: int, dev, dtype):
    local = torch.arange(n_t, device=dev)
    pix = torch.arange(tile_size * tile_size, device=dev)
    px = ((local % grid_w) * tile_size)[:, None] + pix % tile_size + 0.5
    py = ((local // grid_w) * tile_size)[:, None] + pix // tile_size + 0.5
    return px.to(dtype), py.to(dtype)


def composite_tiles(data: torch.Tensor, counts: torch.Tensor, grid_w: int,
                    tile_size: int = 16, acc_dtype=torch.float64):
    """``(T, 16, K)`` worklists of one view -> ``(T, 8, P)``, walking each
    tile in 128-instance chunks and stopping a tile once every pixel's
    transmittance is ``<= T_EPS``; a chunk's sums in ``acc_dtype``.
    Returns ``(out, kept)``: ``kept (T,)``, the (pixel, instance) pairs of
    the walk whose alpha passes the cutoff."""
    n_t, _, cap = data.shape
    p = tile_size * tile_size
    dev, dt = data.device, data.dtype
    px, py = (c[..., None] for c in pixel_centres(n_t, grid_w, tile_size,
                                                  dev, dt))
    rgb = data.new_zeros(n_t, p, 3)
    dep = data.new_zeros(n_t, p)
    acc = data.new_zeros(n_t, p)
    trans = data.new_ones(n_t, p)
    counts = torch.clamp_max(counts.to(torch.int64), cap)
    kept = torch.zeros_like(counts)
    active = counts > 0
    for k0 in range(0, cap, CHUNK):
        if not bool(active.any()):
            break
        ids = torch.nonzero(active).squeeze(1)
        blk = data[ids, :, k0:k0 + CHUNK]                      # (A, 16, C)
        c = blk.shape[-1]
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
        w = (alpha * t_in * trans[ids, :, None]).to(acc_dtype)
        rgb[ids] += torch.stack([(w * blk[:, None, 5 + ch, :].to(acc_dtype))
                                 .sum(-1) for ch in range(3)], dim=-1).to(dt)
        dep[ids] += (w * blk[:, None, 9, :].to(acc_dtype)).sum(-1).to(dt)
        acc[ids] += w.sum(-1).to(dt)
        trans[ids] = trans[ids] * t_in[..., -1] * one_m[..., -1]
        active[ids] = (k0 + CHUNK < counts[ids]) & (trans[ids].amax(-1)
                                                    > T_EPS)
    out = torch.cat([rgb, dep[..., None], acc[..., None]], dim=-1)
    return out.transpose(1, 2), kept


@torch.no_grad()
def render_view(camera, xyz, colors, opac, scales, rotations, h: int, w: int,
                tile_capacity: int, dtype=torch.float32, tile_size: int = 16,
                max_tiles: tuple = (32, 32), near: float = 0.01):
    """One scene's gaussians (``(P, ...)``, ``opac (P,)``) in one camera ->
    ``(image (3, h, w) in [-1, 1], depth (1, h, w), alpha (1, h, w),
    kept)``: the port's ``render_gaussians`` contract."""
    cast = lambda t: t.to(dtype)
    proj = project_view(cast(camera), cast(xyz), cast(scales),
                        cast(rotations), cast(opac), h, w, near)
    grid_h, grid_w = h // tile_size, w // tile_size
    st, sg = sorted_instances(proj, tile_size, grid_w, grid_h, max_tiles,
                              opacities=cast(opac))
    g, in_seg, counts = tile_segments(st, sg, grid_w * grid_h, tile_capacity)
    data = gather_rows(proj, cast(colors), cast(opac), g, in_seg)
    acc_dtype = torch.float64 if dtype == torch.float32 else dtype
    out, kept = composite_tiles(data, counts, grid_w, tile_size, acc_dtype)
    out = out.reshape(grid_h, grid_w, 5, tile_size, tile_size)
    out = out.permute(2, 0, 3, 1, 4).reshape(5, h, w).float()
    rgb, acc_d, acc_a = out[:3], out[3], out[4]
    bg = torch.tensor(BACKGROUND, device=rgb.device)[:, None, None]
    image = (rgb + (1.0 - acc_a[None]) * bg) * 2.0 - 1.0
    depth = acc_d / torch.clamp_min(acc_a, 1e-10)
    return image, depth[None], torch.clamp(acc_a, 0.0, 1.0)[None], kept


def render(cameras, gaussians, h: int, w: int, tile_capacity: int = 1024,
           dtype=torch.float32):
    """``cameras (B, N, 18)`` and a batched gaussian tuple ``(xyz, features
    (B, P, 1, 3), opacity (B, P, 1), scales, rotations)`` -> ``(images (B,
    N, 3, h, w), depths (B, N, 1, h, w))``, float32."""
    xyz, feats, opacity, scales, rots = (g.float() for g in gaussians)
    imgs, deps = [], []
    for b in range(cameras.shape[0]):
        for n in range(cameras.shape[1]):
            im, dp, _, _ = render_view(cameras[b, n].float(), xyz[b],
                                       feats[b, :, 0], opacity[b, :, 0],
                                       scales[b], rots[b], h, w,
                                       tile_capacity, dtype)
            imgs.append(im)
            deps.append(dp)
    B, N = cameras.shape[:2]
    return (torch.stack(imgs).reshape(B, N, 3, h, w),
            torch.stack(deps).reshape(B, N, 1, h, w))
