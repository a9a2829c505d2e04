"""Weights for the port's modules: the JAX bridge and a seeded random init.

The port names its submodules after the flax modules, so a JAX param path
maps onto a PyTorch name mechanically:

- flax's auto-named inner modules (``Conv_0``, ``GroupNorm_0``) drop out;
- ``kernel`` becomes ``weight``: Dense ``(in, out)`` -> ``(out, in)``,
  conv HWIO -> OIHW;
- ``scale`` (LayerNorm, GroupNorm) and ``embedding`` become ``weight``;
- a conv-transpose kernel (flax ``ConvTranspose(transpose_kernel=True)``,
  ``(kh, kw, out, in)``) takes the conv rule and lands in torch's
  ``ConvTranspose2d`` layout ``(in, out, kh, kw)`` with no flip;
- a raw parameter (TrajDiT's ``pos_embed``, the image towers' class and
  position embeddings, DINOv2's ``cls_token`` and layer scales ``ls1``,
  ``ls2``) keeps its name and layout;
- ``batch_stats`` entries (the EMANorm magnitudes) load into buffers.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

_AUTO_NAMED = {"Conv_0", "GroupNorm_0"}


def _flatten(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _jax_name(path: tuple) -> tuple[str, bool]:
    """JAX param path -> ``(torch name, is_kernel)``."""
    parts = [p for p in path if p not in _AUTO_NAMED]
    leaf = parts[-1]
    is_kernel = leaf == "kernel"
    if leaf in ("kernel", "scale", "embedding"):
        leaf = "weight"
    return ".".join(parts[:-1] + [leaf]), is_kernel


@torch.no_grad()
def load_jax_params(module: nn.Module, tree: Mapping) -> list[str]:
    """Copy a JAX param tree (nested dicts of numpy arrays) into ``module``.

    ``tree`` is either a flax variables dict (``{"params": ...,
    "batch_stats": ...}``) or a bare params tree. Every parameter and buffer
    of ``module`` must receive a value of its shape. Returns the JAX paths
    that have no counterpart in the port (e.g. the VAE encoder of the
    MV-LDM tree, which the port's inference model does not hold).
    """
    collections = tree if "params" in tree else {"params": tree}
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    loaded, unused = set(), []
    for coll in collections.values():
        for path, value in _flatten(coll):
            name, is_kernel = _jax_name(path)
            if name not in targets:
                unused.append("/".join(path))
                continue
            arr = np.asarray(value).astype(np.float32)
            if is_kernel:
                arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
            dst = targets[name]
            if tuple(dst.shape) != arr.shape:
                raise ValueError(f"{'/'.join(path)}: JAX shape {arr.shape} "
                                 f"!= {name} {tuple(dst.shape)}")
            dst.copy_(torch.tensor(arr))
            loaded.add(name)
    missing = sorted(set(targets) - loaded)
    if missing:
        raise KeyError(f"no JAX value for {len(missing)} tensors, e.g. "
                       f"{missing[:4]}")
    return unused


def random_module(cls, kwargs: dict, device: torch.device | str,
                  generator: torch.Generator) -> nn.Module:
    """``cls(**kwargs)`` built on the meta device, then materialised on
    ``device`` with ``init_random_``'s weights from ``generator``. The
    module keeps ``kwargs`` as ``init_kwargs``: the widths a release
    bundle records (``checkpoint.save_bundle``)."""
    with torch.device("meta"):
        module = cls(**kwargs)
    module.to_empty(device=device)
    init_random_(module, generator)
    module.init_kwargs = dict(kwargs)
    return module


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights: matrices and conv kernels ``N(0, 1/fan_in)``,
    the CLIP position tables ``N(0, 0.01^2)``, norm scales and DINOv2's
    layer scales 1, biases and other parameters (TrajDiT's and DINOv2's
    position tables, class tokens) 0, EMANorm magnitudes 1.

    No layer starts at zero (the JAX package zero-initialises its output
    projections), so every block of a randomly initialised model shapes
    the output.
    """
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "position_embedding":
            p.normal_(0.0, 0.01, generator=generator)
        elif leaf == "weight" and p.dim() >= 2:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
        elif leaf in ("weight", "ls1", "ls2"):
            p.fill_(1.0)
        else:
            p.zero_()
    for _, b in module.named_buffers():
        b.fill_(1.0)
