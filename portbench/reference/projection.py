# Frozen copy of prometheus_torch/ops/gaussian/projection.py at commit 078c4a5; imports
# rewritten to this package, kernel A replaced by plain attention.
"""3D Gaussian -> screen-space projection (EWA splatting)
(``prometheus_tpu/ops/gaussian/projection.py``).

    Sigma   = R S S^T R^T                       world-space covariance
    t       = W p + c                           camera space, +z forward
    Sigma2D = J W Sigma W^T J^T + eps2d * I     screen space, low-pass dilated

Camera space is OpenCV (x right, y down, z forward); the renderer converts
the OpenGL camera vectors before calling in.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .cameras import camera_c2w, opengl_to_opencv
from .quaternion import quaternion_to_matrix

EPS2D = 0.3
RADIUS_CUTOFF = 3.0
ALPHA_CUTOFF = 1.0 / 255.0
MAX_ALPHA = 0.999


class Projected(NamedTuple):
    """Per-gaussian screen-space quantities (leading dim = gaussians)."""

    mean2d: torch.Tensor   # (N, 2) pixel coords
    conic: torch.Tensor    # (N, 3) inverse 2D covariance (a, b, c)
    depth: torch.Tensor    # (N,) camera-space z, inf where culled
    radius: torch.Tensor   # (N,) isotropic bounding radius, 0 where culled
    valid: torch.Tensor    # (N,) bool
    rx: torch.Tensor | None = None   # (N,) exact horizontal AABB half-extent
    ry: torch.Tensor | None = None   # (N,) exact vertical AABB half-extent


def bbox_extents(proj: Projected) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-axis bounding half-extents ``(rx, ry)`` with isotropic fallback."""
    rx = proj.radius if proj.rx is None else proj.rx
    ry = proj.radius if proj.ry is None else proj.ry
    return rx, ry


def covariance_3d(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """World-space covariance ``R diag(s^2) R^T`` -> ``(..., 3, 3)``."""
    R = quaternion_to_matrix(quats)
    return (R * (scales**2)[..., None, :]) @ R.transpose(-1, -2)


def w2c_from_camera_vector(camera: torch.Tensor) -> torch.Tensor:
    """18-dim OpenGL camera vector -> (4, 4) OpenCV world-to-camera."""
    c2w = camera_c2w(camera)
    c2w_cv = torch.cat([opengl_to_opencv(c2w[:3, :4]),
                        camera.new_tensor([[0.0, 0.0, 0.0, 1.0]])], dim=0)
    return torch.linalg.inv(c2w_cv)


def project_gaussians(means3d, scales, quats, w2c, fx, fy, cx, cy,
                      img_h: int, img_w: int, near: float = 0.01,
                      far: float = 1e10, eps2d: float = EPS2D,
                      opacities: torch.Tensor | None = None) -> Projected:
    """Project ``(N, ...)`` gaussians into one camera (``w2c`` (4, 4)).

    With ``opacities`` the bounding radius solves
    ``op * exp(-r^2 / (2 lambda)) = ALPHA_CUTOFF`` and splats with
    ``op <= ALPHA_CUTOFF`` are culled, which keeps tile binning exact with
    respect to the compositors' alpha cutoff.
    """
    R = w2c[:3, :3]
    t = w2c[:3, 3]
    p_cam = means3d @ R.T + t
    tz = p_cam[..., 2]
    in_depth = (tz > near) & (tz < far)
    tz_safe = torch.where(in_depth, tz, torch.ones_like(tz))

    lim_x = 1.3 * (0.5 * img_w / fx)
    lim_y = 1.3 * (0.5 * img_h / fy)
    txz = torch.clamp(p_cam[..., 0] / tz_safe, -lim_x, lim_x)
    tyz = torch.clamp(p_cam[..., 1] / tz_safe, -lim_y, lim_y)

    Rg = quaternion_to_matrix(quats)
    s2 = scales**2
    M = [[R[i, 0] * Rg[..., 0, k] + R[i, 1] * Rg[..., 1, k]
          + R[i, 2] * Rg[..., 2, k] for k in range(3)] for i in range(3)]

    def cc(i, j):
        return (s2[..., 0] * M[i][0] * M[j][0]
                + s2[..., 1] * M[i][1] * M[j][1]
                + s2[..., 2] * M[i][2] * M[j][2])

    inv_z = 1.0 / tz_safe
    j00 = fx * inv_z
    j02 = -fx * txz * inv_z
    j11 = fy * inv_z
    j12 = -fy * tyz * inv_z
    c00, c01, c02 = cc(0, 0), cc(0, 1), cc(0, 2)
    c11, c12, c22 = cc(1, 1), cc(1, 2), cc(2, 2)
    a00 = j00 * c00 + j02 * c02
    a01 = j00 * c01 + j02 * c12
    a02 = j00 * c02 + j02 * c22
    b11 = j11 * c11 + j12 * c12
    b12 = j11 * c12 + j12 * c22
    cov00 = a00 * j00 + a02 * j02 + eps2d
    cov01 = a01 * j11 + a02 * j12
    cov11 = b11 * j11 + b12 * j12 + eps2d

    det = cov00 * cov11 - cov01 * cov01
    valid = in_depth & (det > 0)
    det_safe = torch.where(valid, det, torch.ones_like(det))
    conic = torch.stack([cov11 / det_safe, -cov01 / det_safe,
                         cov00 / det_safe], dim=-1)
    mean2d = torch.stack([fx * p_cam[..., 0] * inv_z + cx,
                          fy * p_cam[..., 1] * inv_z + cy], dim=-1)

    b = 0.5 * (cov00 + cov11)
    v1 = b + torch.sqrt(torch.clamp_min(b * b - det, 0.01))
    if opacities is None:
        k = torch.full_like(v1, RADIUS_CUTOFF)
    else:
        op = opacities.detach()
        k = torch.sqrt(torch.clamp_min(2.0 * torch.log(
            torch.clamp_min(op, 1e-12) / ALPHA_CUTOFF), 0.0))
        valid = valid & (op > ALPHA_CUTOFF)
    radius = k * torch.sqrt(v1)
    rx = k * torch.sqrt(torch.clamp_min(cov00, 0.0))
    ry = k * torch.sqrt(torch.clamp_min(cov11, 0.0))
    inside = ((mean2d[..., 0] + rx > 0) & (mean2d[..., 0] - rx < img_w)
              & (mean2d[..., 1] + ry > 0) & (mean2d[..., 1] - ry < img_h))
    valid = valid & inside
    zero = torch.zeros_like(radius)
    radius = torch.where(valid, radius, zero)
    rx = torch.where(valid, rx, zero)
    ry = torch.where(valid, ry, zero)
    depth = torch.where(valid, tz, torch.full_like(tz, float("inf")))
    return Projected(mean2d, conic, depth, radius, valid, rx=rx, ry=ry)
