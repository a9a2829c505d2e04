# Frozen copy of prometheus_torch/utils/quaternion.py at commit 078c4a5; imports
# rewritten to this package, kernel A replaced by plain attention.
"""Quaternion and rotation utilities (``prometheus_tpu/utils/quaternion.py``).

Quaternions are ``(w, x, y, z)``, real part first. ``matrix_to_quaternion``
is branchless (Shepperd's method with a four-way select), so it runs on
whole batches on the card.
"""
from __future__ import annotations

import torch


def quaternion_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalise quaternions along the last axis."""
    return q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), eps)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """``(..., 4)`` quaternions -> ``(..., 3, 3)`` rotations.

    Un-normalised quaternions are handled by the ``2 / |q|^2`` factor.
    """
    w, x, y, z = q.unbind(-1)
    two_s = 2.0 / torch.clamp_min((q * q).sum(-1), 1e-12)
    m = torch.stack([
        1 - two_s * (y * y + z * z),
        two_s * (x * y - z * w),
        two_s * (x * z + y * w),
        two_s * (x * y + z * w),
        1 - two_s * (x * x + z * z),
        two_s * (y * z - x * w),
        two_s * (x * z - y * w),
        two_s * (y * z + x * w),
        1 - two_s * (x * x + y * y),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """``(..., 3, 3)`` rotations -> ``(..., 4)`` unit quaternions, ``w >= 0``.

    The candidate of each of the four pivots (4w^2, 4x^2, 4y^2, 4z^2) is
    computed and the one of the largest pivot kept; on a tie the first
    pivot wins, as in ``jnp.argmax``.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp_min(v, 1e-12))

    sw, sx, sy, sz = (safe_sqrt(v) for v in (qw2, qx2, qy2, qz2))
    cands = torch.stack([
        torch.stack([0.25 * sw * 2.0, (m21 - m12) / (2.0 * sw),
                     (m02 - m20) / (2.0 * sw), (m10 - m01) / (2.0 * sw)], -1),
        torch.stack([(m21 - m12) / (2.0 * sx), 0.25 * sx * 2.0,
                     (m01 + m10) / (2.0 * sx), (m02 + m20) / (2.0 * sx)], -1),
        torch.stack([(m02 - m20) / (2.0 * sy), (m01 + m10) / (2.0 * sy),
                     0.25 * sy * 2.0, (m12 + m21) / (2.0 * sy)], -1),
        torch.stack([(m10 - m01) / (2.0 * sz), (m02 + m20) / (2.0 * sz),
                     (m12 + m21) / (2.0 * sz), 0.25 * sz * 2.0], -1),
    ], dim=-2)                                             # (..., 4, 4)
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], -1), dim=-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return quaternion_normalize(q)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of ``(w, x, y, z)`` quaternions (broadcasting)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quaternion_slerp(q0: torch.Tensor, q1: torch.Tensor, t,
                     eps: float = 1e-7) -> torch.Tensor:
    """Spherical linear interpolation between unit quaternions along the
    short arc; plain lerp where they are nearly parallel (dot above
    ``1 - 1e-5``). ``t`` broadcasts against the batch dims."""
    q0 = quaternion_normalize(q0)
    q1 = quaternion_normalize(q1)
    dot = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.clamp(dot.abs(), -1.0, 1.0)
    theta = torch.arccos(torch.clamp(dot, 0.0, 1.0 - eps))
    sin_theta = torch.clamp_min(torch.sin(theta), eps)
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.dim() < dot.dim():
        t = t[..., None]
    use_lerp = dot > 1.0 - 1e-5
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / sin_theta)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / sin_theta)
    return quaternion_normalize(w0 * q0 + w1 * q1)
