"""Batched differentiable 3DGS renderer
(``prometheus_tpu/ops/gaussian/renderer.py``).

Output contract (gsplat ``RGB+ED``, as the reference uses it): RGB is
alpha-composited, then blended over the background and mapped to [-1, 1];
depth is the expected depth (accumulated / alpha, no background); alpha is
in [0, 1]. Each view is projected on its own (autograd differentiates the
projection); the worklists of all views then go through ONE compositor
launch, forward and backward (``composite_grad.CompositeFunction``: kernel B
and kernel C).

``render_gaussians_tile_sharded`` splits each image's rows into one band a
rank of a process group: every rank projects all gaussians with the full
intrinsics, keeps those whose support meets its band, composites the band
through kernel B, and the bands are all-gathered; they equal the rows of
one render.
"""
from __future__ import annotations

import torch

from ... import profiling
from ...utils.cameras import camera_intrinsics
from .composite_grad import composite_tiled_grad
from ...parallel.dist import all_gather_cat, get_rank, resolve_group, \
    world_size
from .projection import (Projected, bbox_extents, project_gaussians,
                         w2c_from_camera_vector)

DEFAULT_BACKGROUND = (1.0, 1.0, 1.0)


def project_view(camera, xyz, scales, rotations, opacity, h: int, w: int,
                 near: float = 0.01, band: tuple | None = None) -> Projected:
    """Project one scene's gaussians into one 18-dim camera. ``band=(y0,
    band_h)``: the pixel rows ``[y0, y0 + band_h)`` of the ``h x w`` image,
    as an image of its own: the means move up by ``y0`` and the gaussians
    whose vertical support misses the band are culled."""
    fx, fy, cx, cy, _, _ = camera_intrinsics(camera, h=h, w=w)
    proj = project_gaussians(xyz, scales, rotations,
                             w2c_from_camera_vector(camera),
                             fx, fy, cx, cy, h, w, near=near,
                             opacities=opacity)
    if band is None:
        return proj
    y0, band_h = band
    yc = proj.mean2d[:, 1]
    _, ry = bbox_extents(proj)
    keep = (yc + ry > y0) & (yc - ry < y0 + band_h)
    return proj._replace(
        mean2d=proj.mean2d - proj.mean2d.new_tensor([0.0, float(y0)]),
        valid=proj.valid & keep)


def project_views(cameras, xyz, scales, rotations, opacity, h: int, w: int,
                  near: float = 0.01, band: tuple | None = None) -> Projected:
    """Project ``B`` scenes (``(B, P, ...)`` leaves, ``opacity (B, P)``)
    into their ``N`` cameras each (``cameras (B, N, 18)``): a ``Projected``
    with ``(B * N, P, ...)`` leaves."""
    B, N = cameras.shape[:2]
    projs = [project_view(cameras[b, n], xyz[b], scales[b], rotations[b],
                          opacity[b], h, w, near, band)
             for b in range(B) for n in range(N)]
    return Projected(*(torch.stack(f) for f in zip(*projs)))


def render_gaussians(cameras: torch.Tensor, gaussians, h: int = 256,
                     w: int = 256, bg_color=None, tile_size: int = 16,
                     tile_capacity: int = 1024, max_tiles: tuple = (32, 32),
                     near: float = 0.01, band: tuple | None = None):
    """``cameras (B, N, 18)`` + gaussian tuple -> ``(images (B, N, 3, h, w)
    in [-1, 1], depths (B, N, 1, h, w), masks (B, N, 1, h, w))``,
    differentiable with respect to the gaussians. ``band=(y0, band_h)``
    renders only those rows (see ``project_view``): the outputs are
    ``band_h`` rows high. ``PROMETHEUS_BIN_DECODE`` picks the binning
    (``tiled.sorted_instances``)."""
    xyz, features, opacity, scales, rotations = (
        g.to(torch.float32) for g in gaussians)
    B, N = cameras.shape[:2]
    P = xyz.shape[1]
    cameras = cameras.to(torch.float32)
    colors = features[:, :, 0, :]
    opac = opacity[..., 0]
    with profiling.span("render.project"):
        proj = project_views(cameras, xyz, scales, rotations, opac, h, w,
                             near, band)
    if band is not None:
        h = band[1]
    rgb, depth, alpha = composite_tiled_grad(
        proj, colors[:, None].expand(B, N, P, 3).reshape(B * N, P, 3),
        opac[:, None].expand(B, N, P).reshape(B * N, P), h, w, tile_size,
        tile_capacity, max_tiles)
    bg = torch.tensor(DEFAULT_BACKGROUND if bg_color is None else bg_color,
                      dtype=torch.float32, device=rgb.device)
    rgb = rgb + (1.0 - alpha[..., None]) * bg
    images = rgb.permute(0, 3, 1, 2).reshape(B, N, 3, h, w) * 2.0 - 1.0
    depths = depth.reshape(B, N, 1, h, w)
    masks = torch.clamp(alpha, 0.0, 1.0).reshape(B, N, 1, h, w)
    return images, depths, masks


@torch.no_grad()
def render_gaussians_tile_sharded(group, cameras: torch.Tensor, gaussians,
                                  h: int = 512, w: int = 512, bg_color=None,
                                  tile_size: int = 16,
                                  tile_capacity: int = 1024,
                                  max_tiles: tuple = (32, 32),
                                  near: float = 0.01):
    """``render_gaussians`` with each image's rows split over the ranks of
    ``group`` (None: the world's): rank r composites rows ``[r h / D, (r +
    1) h / D)`` of every view through kernel B, and the bands are gathered,
    so every rank returns the whole ``(images, depths, masks)``, equal to
    one render's. Inference only. Raises ``ValueError`` unless ``h`` splits
    into D bands of whole ``tile_size`` tile rows."""
    group = resolve_group(group)
    D, r = world_size(group), get_rank(group)
    if h % (tile_size * D):
        raise ValueError(f"h={h} must split into {D} equal bands of whole "
                         f"{tile_size}px tile rows")
    band_h = h // D
    out = render_gaussians(cameras, gaussians, h=h, w=w, bg_color=bg_color,
                           tile_size=tile_size, tile_capacity=tile_capacity,
                           max_tiles=max_tiles, near=near,
                           band=(r * band_h, band_h))
    return tuple(all_gather_cat(x, 3, group) for x in out)
