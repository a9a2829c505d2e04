"""Scale-and-shift-invariant (MiDaS-style) depth loss
(``prometheus_tpu/systems/depth_loss.py``).

The per-image affine alignment ``(scale, shift)`` of prediction to target is
solved in closed form from the 2x2 normal equations under a mask; the data
term is the masked MSE of the aligned prediction, plus a multi-scale
gradient-matching term. Every division has a safe denominator on the branch
``torch.where`` does not take, so no NaN reaches the gradient.
``depth_to_disp`` / ``disp_to_depth`` convert between depth and (optionally
2-98% quantile-normalised) disparity.
"""
from __future__ import annotations

import torch


def compute_scale_and_shift(prediction: torch.Tensor, target: torch.Tensor,
                            mask: torch.Tensor):
    """Per-image least squares ``target ~ scale * prediction + shift`` over
    ``(B, H, W)`` inputs -> ``(scale (B,), shift (B,))``; 0 where the
    system is singular."""
    dims = (1, 2)
    a00 = (mask * prediction * prediction).sum(dims)
    a01 = (mask * prediction).sum(dims)
    a11 = mask.sum(dims)
    b0 = (mask * prediction * target).sum(dims)
    b1 = (mask * target).sum(dims)
    det = a00 * a11 - a01 * a01
    valid = det > 0
    det_safe = torch.where(valid, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    scale = torch.where(valid, (a11 * b0 - a01 * b1) / det_safe, zero)
    shift = torch.where(valid, (-a01 * b0 + a00 * b1) / det_safe, zero)
    return scale, shift


def _reduction_batch_based(image_loss: torch.Tensor,
                           m: torch.Tensor) -> torch.Tensor:
    divisor = m.sum()
    safe = torch.clamp_min(divisor, 1e-6)
    return torch.where(divisor > 0, image_loss.sum() / safe,
                       torch.zeros_like(divisor))


def mse_loss(prediction, target, mask):
    res = prediction - target
    image_loss = (mask * res * res).sum((1, 2))
    return _reduction_batch_based(image_loss, 2 * mask.sum((1, 2)))


def gradient_loss(prediction, target, mask):
    diff = mask * (prediction - target)
    grad_x = (diff[:, :, 1:] - diff[:, :, :-1]).abs()
    mask_x = mask[:, :, 1:] * mask[:, :, :-1]
    grad_y = (diff[:, 1:, :] - diff[:, :-1, :]).abs()
    mask_y = mask[:, 1:, :] * mask[:, :-1, :]
    image_loss = (mask_x * grad_x).sum((1, 2)) + (mask_y * grad_y).sum((1, 2))
    return _reduction_batch_based(image_loss, mask.sum((1, 2)))


def scale_and_shift_invariant_loss(prediction: torch.Tensor,
                                   target: torch.Tensor,
                                   mask: torch.Tensor | None = None,
                                   alpha: float = 0.5,
                                   scales: int = 4) -> torch.Tensor:
    """SSI loss over ``(B, H, W)`` disparities with a ``scales``-level
    gradient term weighted by ``alpha``."""
    if mask is None:
        mask = torch.ones_like(prediction)
    scale, shift = compute_scale_and_shift(prediction, target, mask)
    aligned = scale[:, None, None] * prediction + shift[:, None, None]
    total = mse_loss(aligned, target, mask)
    if alpha > 0:
        for s in range(scales):
            step = 2 ** s
            total = total + alpha * gradient_loss(
                aligned[:, ::step, ::step], target[:, ::step, ::step],
                mask[:, ::step, ::step])
    return total


def disp_to_depth(disp: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Normalised disparity in [0, 1] -> depth, ``1 / max(disp, eps)``."""
    return 1.0 / torch.clamp_min(disp, eps)


def _quantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` (linear interpolation over the flattened
    tensor, float32 index arithmetic, NaN if any value is NaN) by one sort,
    so it takes inputs past ``torch.quantile``'s 2**24 elements."""
    flat = torch.sort(x.reshape(-1)).values
    n = flat.numel()
    pos = torch.tensor(q, dtype=flat.dtype) * (
        torch.tensor(n, dtype=flat.dtype) - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lo_i = int(torch.clamp(low, 0, n - 1))
    hi_i = int(torch.clamp(high, 0, n - 1))
    out = flat[lo_i] * (1 - hw).to(flat.device) + flat[hi_i] * hw.to(
        flat.device)
    return torch.where(torch.isnan(flat[-1]), flat[-1], out)


def depth_to_disp(depth: torch.Tensor, eps: float = 1e-4,
                  normalize: bool = True) -> torch.Tensor:
    """Depth -> disparity ``1 / max(depth, eps)``; with ``normalize``,
    mapped to [0, 1] between its 2% and 98% quantiles and clipped."""
    disp = 1.0 / torch.clamp_min(depth, eps)
    if normalize:
        lo = _quantile_linear(disp, 0.02)
        hi = _quantile_linear(disp, 0.98)
        disp = (disp - lo) / torch.clamp_min(hi - lo, 1e-8)
        disp = torch.clamp(disp, 0.0, 1.0)
    return disp
