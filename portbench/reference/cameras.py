# Frozen copy of prometheus_torch/utils/cameras.py at commit 078c4a5; imports
# rewritten to this package, kernel A replaced by plain attention.
"""The 18-dim camera vector (``prometheus_tpu/utils/cameras.py``).

A camera is ``[c2w.flatten()(12), fx, fy, cx, cy, H, W]``: a row-major 3x4
OpenGL camera-to-world pose (+x right, +y up, looking down -z) and pixel
intrinsics at the native resolution ``(H, W)``. ``(fx, cx)`` pair with x /
width and ``(fy, cy)`` with y / height.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .quaternion import (matrix_to_quaternion, quaternion_normalize,
                         quaternion_slerp, quaternion_to_matrix)

CAMERA_DIM = 18


def make_camera(c2w: torch.Tensor, fx, fy, cx, cy, h, w) -> torch.Tensor:
    """Assemble ``(..., 18)`` camera vectors from ``(..., 3, 4)`` poses."""
    batch = c2w.shape[:-2]
    intr = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                        device=c2w.device).expand(batch)
                        for v in (fx, fy, cx, cy, h, w)], dim=-1)
    return torch.cat([c2w.reshape(batch + (12,)), intr], dim=-1)


def camera_c2w(cameras: torch.Tensor) -> torch.Tensor:
    """``(..., 4, 4)`` homogeneous camera-to-world poses."""
    batch = cameras.shape[:-1]
    c2w34 = cameras[..., :12].reshape(batch + (3, 4))
    bottom = cameras.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(batch + (1, 4))
    return torch.cat([c2w34, bottom], dim=-2)


def camera_intrinsics(cameras: torch.Tensor, h=None, w=None):
    """``(fx, fy, cx, cy, H, W)``, optionally rescaled to ``(h, w)``."""
    fx, fy, cx, cy, H, W = (cameras[..., 12 + i] for i in range(6))
    if h is not None:
        fy, cy = fy * h / H, cy * h / H
        H = torch.full_like(H, h)
    if w is not None:
        fx, cx = fx * w / W, cx * w / W
        W = torch.full_like(W, w)
    return fx, fy, cx, cy, H, W


def camera_fov(cameras: torch.Tensor, h=None, w=None):
    """Per-camera ``(fovx, fovy)`` in radians at render resolution."""
    fx, fy, cx, cy, H, W = camera_intrinsics(cameras, h=h, w=w)
    return 2.0 * torch.atan(0.5 * W / fx), 2.0 * torch.atan(0.5 * H / fy)


# Convention conversions take torch tensors or numpy arrays and return the
# same kind: the datasets convert their poses on the host, in numpy.

def opencv_to_opengl(poses):
    """Negate the y and z columns of ``(..., 3, 4)`` poses (an involution)."""
    if isinstance(poses, torch.Tensor):
        return poses * poses.new_tensor([1.0, -1.0, -1.0, 1.0])
    return poses * np.asarray([1.0, -1.0, -1.0, 1.0])


opengl_to_opencv = opencv_to_opengl


def llff_to_opengl(poses):
    """LLFF ``[down, right, backward]`` columns -> OpenGL."""
    cat = torch.cat if isinstance(poses, torch.Tensor) else np.concatenate
    return cat([poses[..., 1:2], -poses[..., 0:1], poses[..., 2:3],
                poses[..., 3:4]], -1)


def matrix_to_square(m):
    """Promote ``(..., 3, 4)`` to homogeneous ``(..., 4, 4)``."""
    batch = m.shape[:-2]
    if isinstance(m, torch.Tensor):
        bottom = m.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(batch + (1, 4))
        return torch.cat([m, bottom], dim=-2)
    bottom = np.broadcast_to(np.asarray([0.0, 0.0, 0.0, 1.0], m.dtype),
                             batch + (1, 4))
    return np.concatenate([m, bottom], axis=-2)


def normalize_poses(c2ws: torch.Tensor, num_input_views: int = -1,
                    eps: float = 1e-2):
    """First-frame-relative poses with max-translation scaling.

    ``c2ws (N, 3, 4)`` OpenGL poses are premultiplied by the inverse of the
    first; translations are divided by ``max_n |t_n| + eps`` over the first
    ``num_input_views`` views (all if -1). Returns ``(normalized (N, 3, 4),
    t_norm)``; callers hold ``t_norm`` against a scene-scale threshold."""
    sq = matrix_to_square(c2ws)
    rel = (torch.linalg.inv(sq[:1]) @ sq)[:, :3, :]
    nv = num_input_views if num_input_views > 0 else c2ws.shape[0]
    t_norm = torch.linalg.norm(rel[:nv, :3, 3], dim=-1).max()
    t = rel[:, :3, 3] / (t_norm + eps)
    return torch.cat([rel[:, :3, :3], t[..., None]], dim=-1), t_norm


def check_valid_rotations(rots: torch.Tensor, tol: float = 1e-5
                          ) -> torch.Tensor:
    """True iff every ``(..., 3, 3)`` block is a proper rotation
    (orthonormal, determinant 1)."""
    eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
    orth = (rots @ rots.transpose(-1, -2) - eye).abs().max()
    det = (torch.linalg.det(rots) - 1.0).abs().max()
    return (orth < tol * 100) & (det < tol * 100)


def look_at(eye: torch.Tensor, target: torch.Tensor,
            up=(0.0, 1.0, 0.0)) -> torch.Tensor:
    """OpenGL look-at: camera z points away from the target. ``(..., 3, 4)``."""
    up = eye.new_tensor(up).expand(eye.shape)
    z = eye - target
    z = z / torch.clamp_min(torch.linalg.norm(z, dim=-1, keepdim=True), 1e-8)
    x = torch.linalg.cross(up, z, dim=-1)
    x = x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True), 1e-8)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z, eye], dim=-1)


def get_random_cameras(n: int, generator: torch.Generator | None = None, *,
                       radius_range=(1.5, 2.5), elev_range=(-30.0, 30.0),
                       fov=60.0, size=256,
                       device: str | torch.device = "cpu") -> torch.Tensor:
    """Random look-at-origin orbit cameras (OpenGL) as ``(n, 18)`` vectors.

    Draws radius, elevation and azimuth, in that order, from ``generator``
    (which must live on ``device``).
    """
    def uniform(lo, hi):
        u = torch.rand(n, generator=generator, device=device)
        return lo + (hi - lo) * u

    radius = uniform(*radius_range)
    elev = torch.deg2rad(uniform(*elev_range))
    azim = uniform(0.0, 2 * math.pi)
    eye = torch.stack([
        radius * torch.cos(elev) * torch.cos(azim),
        radius * torch.sin(elev),
        radius * torch.cos(elev) * torch.sin(azim),
    ], dim=-1)
    c2w = look_at(eye, torch.zeros_like(eye))
    f = 0.5 * size / math.tan(math.radians(fov) / 2)
    return make_camera(c2w, f, f, size / 2.0, size / 2.0, float(size),
                       float(size))


def sample_from_two_poses(pose_a: torch.Tensor, pose_b: torch.Tensor,
                          frac: torch.Tensor,
                          generator: torch.Generator | None = None,
                          noise_strengths=(0.0, 0.0)) -> torch.Tensor:
    """Slerp the rotations and lerp the translations of two ``(..., 3, 4)``
    poses at ``frac``. With ``generator`` and a nonzero strength, the
    quaternion and then the translation get Gaussian noise of that
    standard deviation, drawn from ``generator`` (on the poses' device)."""
    qa = matrix_to_quaternion(pose_a[..., :3, :3])
    qb = matrix_to_quaternion(pose_b[..., :3, :3])
    q = quaternion_slerp(qa, qb, frac)
    t = (1.0 - frac)[..., None] * pose_a[..., :3, 3] \
        + frac[..., None] * pose_b[..., :3, 3]
    if generator is not None and (noise_strengths[0] > 0
                                  or noise_strengths[1] > 0):
        draw = lambda x: torch.randn(x.shape, generator=generator,
                                     device=x.device, dtype=x.dtype)
        q = quaternion_normalize(q + noise_strengths[0] * draw(q))
        t = t + noise_strengths[1] * draw(t)
    return torch.cat([quaternion_to_matrix(q), t[..., None]], dim=-1)


def sample_from_dense_cameras(dense_cameras: torch.Tensor, t: torch.Tensor,
                              generator: torch.Generator | None = None,
                              noise_strengths=(0.0, 0.0, 0.0, 0.0)
                              ) -> torch.Tensor:
    """Resample a ``(B, N, 18)`` camera trajectory at positions ``t (B, M)``
    in [0, 1]: poses slerped between the two neighbouring cameras,
    intrinsics lerped. Returns ``(B, M, 18)``."""
    B, N, _ = dense_cameras.shape
    M = t.shape[1]
    left = torch.clamp(torch.floor(t * (N - 1)).to(torch.int64), 0, N - 2)
    frac = t * (N - 1) - left
    a = torch.gather(dense_cameras, 1, left[..., None].expand(B, M, 18))
    b = torch.gather(dense_cameras, 1, (left + 1)[..., None].expand(B, M, 18))
    pose = sample_from_two_poses(
        a[..., :12].reshape(B, M, 3, 4), b[..., :12].reshape(B, M, 3, 4),
        frac, generator=generator, noise_strengths=noise_strengths[:2])
    intr = (1.0 - frac)[..., None] * a[..., 12:] + frac[..., None] * b[..., 12:]
    return torch.cat([pose.reshape(B, M, 12), intr], dim=-1)
