"""A fixed-capacity gaussian buffer with densify and prune
(``prometheus_tpu/refiners/gs_manager.py``).

Gaussians live in ``C`` slots with an ``alive`` mask: densification writes
copies into dead slots, pruning clears mask bits, so every tensor keeps its
shape and the optimizer's moments keep the buffer's layout. The parameters
are raw (before activation), as in 3DGS: logit colour, logit opacity, log
scales, unnormalised quaternions.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# ``log(1.6)`` rounded as float32 arithmetic rounds it
LOG_1_6 = float(np.log(np.float32(1.6)))


def _inverse_sigmoid(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x = torch.clamp(x, eps, 1 - eps)
    return torch.log(x / (1 - x))


class GaussianBuffer(NamedTuple):
    xyz: torch.Tensor          # (C, 3)
    feats_raw: torch.Tensor    # (C, 3)  logit colour
    opacity_raw: torch.Tensor  # (C,)    logit opacity
    scales_raw: torch.Tensor   # (C, 3)  log scales
    rots_raw: torch.Tensor     # (C, 4)
    alive: torch.Tensor        # (C,) bool


def make_buffer(gaussians, capacity: int) -> GaussianBuffer:
    """An activated gaussian tuple (``(1, N, ...)`` or ``(N, ...)``) ->
    a float32 raw buffer of ``capacity`` slots, the first ``N`` alive.

    Dead slots stay geometrically sound (identity quaternion, scale
    ``e^-6``, opacity logit -10): a zero quaternion or a unit scale would
    give infinite intermediates whose masked gradients become NaN."""
    xyz, feats, opacity, scales, rots = (g.float() for g in gaussians)
    if xyz.dim() == 3:
        xyz, feats, opacity, scales, rots = (
            a[0] for a in (xyz, feats, opacity, scales, rots))
    n = xyz.shape[0]
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} gaussians")
    pad = capacity - n

    def padded(a, fill=0.0):
        return torch.cat([a, a.new_full((pad,) + a.shape[1:], fill)])

    ident = rots.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(pad, 4)
    alive = torch.zeros(capacity, dtype=torch.bool, device=xyz.device)
    alive[:n] = True
    return GaussianBuffer(
        xyz=padded(xyz),
        feats_raw=padded(_inverse_sigmoid(feats.reshape(n, -1)[:, :3])),
        opacity_raw=padded(_inverse_sigmoid(opacity[:, 0]), fill=-10.0),
        scales_raw=padded(torch.log(torch.clamp_min(scales, 1e-8)),
                          fill=-6.0),
        rots_raw=torch.cat([rots, ident]),
        alive=alive)


def activate(buf: GaussianBuffer):
    """Buffer -> activated gaussian tuple ``(1, C, ...)``; dead slots get
    zero opacity, so they never composite. A quaternion of norm at most
    1e-4 becomes the identity through a double ``where``, so its gradient
    has no ``1 / eps`` blow-up."""
    op = torch.sigmoid(buf.opacity_raw) * buf.alive
    norm = torch.linalg.norm(buf.rots_raw, dim=-1, keepdim=True)
    ident = buf.rots_raw.new_tensor([1.0, 0.0, 0.0, 0.0])
    rots = torch.where(norm > 1e-4,
                       buf.rots_raw / torch.clamp_min(norm, 1e-4), ident)
    return (buf.xyz[None], torch.sigmoid(buf.feats_raw)[None, :, None, :],
            op[None, :, None], torch.exp(buf.scales_raw)[None], rots[None])


def num_alive(buf: GaussianBuffer) -> torch.Tensor:
    return buf.alive.sum()


def densify_and_prune(buf: GaussianBuffer, grad_stat: torch.Tensor,
                      noise: torch.Tensor | None = None,
                      generator: torch.Generator | None = None, *,
                      grad_threshold: float = 2e-4,
                      split_scale_threshold: float = 0.02,
                      opacity_prune: float = 0.005,
                      scale_prune_max: float = 0.5,
                      max_new: int = 4096) -> GaussianBuffer:
    """One densify and prune round (3DGS semantics, fixed shapes).

    Candidates are alive slots whose ``grad_stat`` passes the threshold;
    the ``min(max_new, C)`` best (top-k of the stat) are copied into dead
    slots, taken in index order, as far as there are free ones. A
    candidate larger than ``split_scale_threshold`` splits: its copy moves
    by ``noise * scales`` and copy and original shrink by 1.6; a smaller
    one clones in place. ``noise (min(max_new, C), 3)`` is standard normal,
    drawn from ``generator`` unless given. Then slots whose opacity is
    at most ``opacity_prune`` or whose largest scale reaches
    ``scale_prune_max`` die.
    """
    C = buf.xyz.shape[0]
    alive = buf.alive
    scal = torch.exp(buf.scales_raw).amax(-1)
    cand = alive & (grad_stat > grad_threshold)
    score = torch.where(cand, grad_stat,
                        torch.full_like(grad_stat, -float("inf")))
    k = min(max_new, C)
    top_score, src = torch.topk(score, k)
    valid_new = torch.isfinite(top_score)
    # dead slots first, each group in index order (a stable sort)
    dst = torch.argsort(alive.to(torch.uint8), stable=True)[:k]
    dst_ok = ~alive[dst] & valid_new
    is_split = (scal[src] > split_scale_threshold)[:, None]
    if noise is None:
        noise = torch.randn((k, 3), generator=generator,
                            device=buf.xyz.device)
    offset = noise.to(buf.xyz) * torch.exp(buf.scales_raw[src])
    new_xyz = buf.xyz[src] + torch.where(is_split, offset,
                                         torch.zeros_like(offset))
    new_scales = buf.scales_raw[src] - torch.where(
        is_split, LOG_1_6, 0.0).to(buf.scales_raw)

    def scatter(arr, updates):
        out = arr.clone()
        ok = dst_ok.reshape((-1,) + (1,) * (updates.dim() - 1))
        out[dst] = torch.where(ok, updates, arr[dst])
        return out

    scales_raw = scatter(buf.scales_raw, new_scales)
    shrink = torch.zeros(C, dtype=torch.bool, device=alive.device)
    shrink[src] = is_split[:, 0] & valid_new & dst_ok
    scales_raw = torch.where(shrink[:, None], scales_raw - LOG_1_6,
                             scales_raw)
    opacity_raw = scatter(buf.opacity_raw, buf.opacity_raw[src])
    keep = (scatter(alive, torch.ones_like(dst_ok))
            & (torch.sigmoid(opacity_raw) > opacity_prune)
            & (torch.exp(scales_raw).amax(-1) < scale_prune_max))
    return GaussianBuffer(
        xyz=scatter(buf.xyz, new_xyz),
        feats_raw=scatter(buf.feats_raw, buf.feats_raw[src]),
        opacity_raw=opacity_raw, scales_raw=scales_raw,
        rots_raw=scatter(buf.rots_raw, buf.rots_raw[src]), alive=keep)
