"""Seeded random weights, made on the device in one draw per module.

The rule is the port's ``weights.init_random_`` (commit 078c4a5), frozen:
matrices and conv kernels ``N(0, 1/fan_in)``, CLIP position tables ``N(0,
0.01^2)``, norm scales and layer scales 1, biases and other parameters 0,
buffers 1. All normal values of a module come from one ``torch.randn`` call
in the module's dtype, handed out to the parameters in name order, so the
program's module and the reference's frozen copy (same names, same shapes)
receive the same values from the same seed.
"""
from __future__ import annotations

import torch
from torch import nn


def _std(name: str, p: torch.Tensor) -> float | None:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "position_embedding":
        return 0.01
    if leaf == "weight" and p.dim() >= 2:
        return p[0].numel() ** -0.5
    return None


@torch.no_grad()
def fill_(module: nn.Module, generator: torch.Generator) -> None:
    named = sorted(module.named_parameters())
    drawn = [(n, p, s) for n, p in named if (s := _std(n, p)) is not None]
    if drawn:
        dtype = drawn[0][1].dtype
        flat = torch.randn(sum(p.numel() for _, p, _ in drawn),
                           generator=generator, device=drawn[0][1].device,
                           dtype=dtype)
        off = 0
        for _, p, std in drawn:
            p.copy_(flat[off:off + p.numel()].view_as(p)).mul_(std)
            off += p.numel()
        del flat
    for n, p in named:
        if _std(n, p) is None:
            leaf = n.rsplit(".", 1)[-1]
            p.fill_(1.0 if leaf in ("weight", "ls1", "ls2") else 0.0)
    for _, b in module.named_buffers():
        b.fill_(1.0)


def build(cls, kwargs: dict, device, dtype: torch.dtype) -> nn.Module:
    """``cls(**kwargs)`` on the meta device, cast, then given storage on
    ``device`` (not yet filled), in eval mode and without gradients."""
    with torch.device("meta"):
        module = cls(**kwargs)
    return module.to(dtype).to_empty(device=device).eval().requires_grad_(False)


def make(specs, seed: int | None, device, dtype: torch.dtype,
         generator: torch.Generator | None = None) -> list[nn.Module]:
    """``[(cls, kwargs), ...]`` -> the modules, filled in that order from
    one generator seeded with ``seed`` on ``device`` (or ``generator``)."""
    g = generator or torch.Generator(device=device).manual_seed(int(seed))
    mods = []
    for cls, kwargs in specs:
        m = build(cls, kwargs, device, dtype)
        fill_(m, g)
        mods.append(m)
    return mods
