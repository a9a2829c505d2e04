"""Scenes and camera paths of the renderer's traffic.

``make_trained_stats_scene`` is a frozen copy (commit 078c4a5) of
``prometheus_torch/ops/gaussian/quality.py::make_trained_stats_scene``:
splats with a trained model's statistics in front of a camera. ``orbit_arc``
gives a 29-camera orbit around the origin whose middle camera is the
scene's, its span and direction drawn from a generator.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.cameras import look_at, make_camera


@torch.no_grad()
def make_trained_stats_scene(cameras: torch.Tensor,
                             generator: torch.Generator,
                             n_gaussians: int = 524288, z_near: float = 0.2,
                             z_far: float = 30.0):
    """A scene in front of the first camera of ``cameras (..., 18)``:
    positions along rays of a ~70-degree cone, depth lognormal around 3;
    scales lognormal (sigma 0.6) around 1.5 pixel footprints at that depth,
    2% of them 20x larger; opacity 60% Beta(1, 20), 40% Beta(20, 2);
    uniform unit quaternions and colours. A single-scene tuple (batch dim
    1): ``(xyz, colors (1, P, 1, 3), opacity (1, P, 1), scales,
    rotations)``."""
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


def orbit_camera(radius: float, elev_deg: float, azim_deg, size: int,
                 fov: float = 60.0, device="cpu") -> torch.Tensor:
    """Look-at-origin cameras ``(n, 18)`` at the given azimuths."""
    az = torch.deg2rad(torch.as_tensor(azim_deg, dtype=torch.float32,
                                       device=device)).reshape(-1)
    el = math.radians(elev_deg)
    eye = torch.stack([radius * math.cos(el) * torch.cos(az),
                       torch.full_like(az, radius * math.sin(el)),
                       radius * math.cos(el) * torch.sin(az)], dim=-1)
    f = 0.5 * size / math.tan(math.radians(fov) / 2)
    return make_camera(look_at(eye, torch.zeros_like(eye)), f, f, size / 2.0,
                       size / 2.0, float(size), float(size))


def orbit_arc(base: tuple, generator: torch.Generator, size: int,
              n: int = 29, span=(20.0, 40.0)) -> torch.Tensor:
    """``(1, n, 18)``: ``n`` cameras on the orbit of ``base = (radius,
    elevation, azimuth)`` (degrees), centred on its azimuth, over a span
    and a direction drawn from ``generator``."""
    dev = generator.device
    u = torch.rand(2, generator=generator, device=dev).tolist()
    width = span[0] + (span[1] - span[0]) * u[0]
    sign = 1.0 if u[1] < 0.5 else -1.0
    radius, elev, azim = base
    az = azim + sign * torch.linspace(-width / 2, width / 2, n)
    return orbit_camera(radius, elev, az, size, device=dev)[None]
