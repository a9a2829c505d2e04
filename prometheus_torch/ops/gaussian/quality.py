"""Render quality against the exact compositor
(``prometheus_tpu/ops/gaussian/quality.py``).

``psnr_vs_exact`` holds the production render (projection, the binning
that ``PROMETHEUS_BIN_DECODE`` picks, at a tile capacity, kernel B) against
``composite_exact_pixels`` on a
random subset of tiles. ``make_trained_stats_scene`` draws a scene with the
splat statistics of a trained model (mostly sub-tile splats, bimodal
opacity), where random decoder weights give nearly opaque all-big splats.
"""
from __future__ import annotations

import math

import torch

from .naive import composite_exact_pixels
from .renderer import DEFAULT_BACKGROUND, project_view, render_gaussians


@torch.no_grad()
def psnr_vs_exact(camera: torch.Tensor, gaussians,
                  generator: torch.Generator | None = None, *,
                  tiles: torch.Tensor | None = None, h: int = 512,
                  w: int = 512, tile_size: int = 16,
                  tile_capacity: int = 1024, max_tiles: tuple = (32, 32),
                  n_sample_tiles: int = 48, near: float = 0.01,
                  chunk: int = 4096) -> float:
    """PSNR in dB (images in [-1, 1], so the data range is 2) of the
    production render of one view ``camera (18,)`` of a single-scene
    gaussian tuple (``xyz (P, 3)``, ``features (P, 1, 3)``, ``opacity
    (P, 1)``, ``scales (P, 3)``, ``rotations (P, 4)``) against the exact
    compositor, over ``tiles`` (flat tile indices) or ``n_sample_tiles``
    tiles drawn without replacement from ``generator``. Both sides are
    blended over the background and mapped to [-1, 1].
    """
    xyz, features, opacity, scales, rotations = (
        g.to(torch.float32) for g in gaussians)
    camera = camera.to(torch.float32)
    dev = xyz.device
    img_prod = render_gaussians(
        camera[None, None], tuple(g[None] for g in gaussians), h=h, w=w,
        tile_size=tile_size, tile_capacity=tile_capacity,
        max_tiles=max_tiles, near=near)[0][0, 0]              # (3, h, w)

    grid_w = w // tile_size
    n_tiles = (h // tile_size) * grid_w
    if tiles is None:
        tiles = torch.randperm(n_tiles, generator=generator,
                               device=generator.device if generator
                               else "cpu")[:n_sample_tiles]
    tiles = tiles.to(device=dev, dtype=torch.int64)
    ty, tx = tiles // grid_w, tiles % grid_w
    r = torch.arange(tile_size, device=dev)
    pix_y = (ty[:, None, None] * tile_size + r[None, :, None]).expand(
        -1, tile_size, tile_size).reshape(-1)
    pix_x = (tx[:, None, None] * tile_size + r[None, None, :]).expand(
        -1, tile_size, tile_size).reshape(-1)
    px = torch.stack([pix_x + 0.5, pix_y + 0.5], dim=-1).to(torch.float32)

    opac = opacity[..., 0]
    proj = project_view(camera, xyz, scales, rotations, opac, h, w, near)
    rgb_e, _, alpha_e = composite_exact_pixels(proj, features[:, 0, :], opac,
                                               px, chunk=chunk)
    bg = torch.tensor(DEFAULT_BACKGROUND, dtype=torch.float32, device=dev)
    img_exact = (rgb_e + (1.0 - alpha_e[:, None]) * bg) * 2.0 - 1.0
    mse = float(((img_prod[:, pix_y, pix_x].T - img_exact) ** 2).mean())
    return 10.0 * math.log10(4.0 / max(mse, 1e-12))


@torch.no_grad()
def make_trained_stats_scene(cameras: torch.Tensor,
                             generator: torch.Generator,
                             n_gaussians: int = 524288, z_near: float = 0.2,
                             z_far: float = 30.0):
    """A scene with trained-model splat statistics in front of the first
    camera of ``cameras (..., 18)``, drawn from ``generator`` (on the
    cameras' device); the JAX version's distributions, not its bits:

    - positions along rays of a ~70-degree cone, depth lognormal around 3;
    - scales lognormal (sigma 0.6) around 1.5 pixel footprints at that
      depth, 2% of them 20x larger;
    - opacity bimodal: 60% Beta(1, 20), 40% Beta(20, 2), drawn as order
      statistics of uniforms;
    - rotations uniform unit quaternions, colours uniform.

    Returns a single-scene tuple with batch dim 1.
    """
    n, dev = n_gaussians, cameras.device
    uni = lambda *s: torch.rand(*s, generator=generator, device=dev)
    normal = lambda *s: torch.randn(*s, generator=generator, device=dev)
    cam = cameras.reshape(-1, 18)[0].to(torch.float32)
    c2w = cam[:12].reshape(3, 4)
    origin, fwd = c2w[:, 3], -c2w[:, 2]       # OpenGL: looks down -z
    right, up = c2w[:, 0], c2w[:, 1]

    u = uni(n) * 1.4 - 0.7
    v = uni(n) * 1.4 - 0.7
    dirs = fwd + u[:, None] * right + v[:, None] * up
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    depth = torch.clamp(torch.exp(normal(n) * 0.7 + math.log(3.0)), z_near,
                        z_far)
    xyz = origin + dirs * depth[:, None]

    px_world = depth / torch.clamp_min(cam[12], 1.0)
    scales = (1.5 * px_world)[:, None] * torch.exp(normal(n, 3) * 0.6)
    scales = torch.where(uni(n, 1) < 0.02, scales * 20.0, scales)

    def beta(a: int, b: int):     # the a-th smallest of a + b - 1 uniforms
        return uni(n, a + b - 1).kthvalue(a, dim=1).values[:, None]

    opacity = torch.where(uni(n, 1) < 0.4, beta(20, 2), beta(1, 20))
    q = normal(n, 4)
    rotations = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    colors = uni(n, 1, 3)
    return (xyz[None], colors[None], opacity[None], scales[None],
            rotations[None])
