"""NaN / Inf guards (``prometheus_tpu/utils/nan_guard.py``).

- ``enable_nan_debug()``: ``torch.autograd.set_detect_anomaly(True)``, the
  reference's debug-run switch: the backward raises at the operation whose
  gradient turned non-finite and names it (slow; debug runs only).
- ``check_finite(tree, name)``: prints a message when a floating leaf of
  ``tree`` holds NaN or Inf and returns ``tree`` unchanged, so it composes
  as ``x = check_finite(x, "vae.decode")``; it reads one flag back from the
  device.
- ``assert_finite(tree, name)``: the hard check for data batches and loaded
  checkpoints: raises ``FloatingPointError`` naming the offending leaves.

A tree is a tensor, a numpy array, or a dict / list / tuple of them; other
leaves (captions) are skipped.
"""
from __future__ import annotations

import numpy as np
import torch


def enable_nan_debug(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


def _leaves(tree, path: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _nonfinite(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point() and not bool(
            torch.isfinite(leaf).all())
    if isinstance(leaf, (np.ndarray, np.floating, float)):
        arr = np.asarray(leaf)
        return np.issubdtype(arr.dtype, np.floating) and \
            not np.isfinite(arr).all()
    return False


def check_finite(tree, name: str = "tensor"):
    """Print when ``tree`` holds NaN or Inf; return it unchanged."""
    if any(_nonfinite(leaf) for _, leaf in _leaves(tree)):
        print(f"[nan-guard] NON-FINITE values in {name}", flush=True)
    return tree


def assert_finite(tree, name: str = "tensor") -> None:
    """Raise ``FloatingPointError`` listing the leaves of ``tree`` that
    hold NaN or Inf."""
    bad = [p for p, leaf in _leaves(tree) if _nonfinite(leaf)]
    if bad:
        raise FloatingPointError(
            f"[nan-guard] non-finite values in {name}: {bad[:8]}"
            + (f" (+{len(bad) - 8} more)" if len(bad) > 8 else ""))
