"""The control: a reference module run one precision step below the
configuration's.

``fp8_`` casts a module to bf16, rounds every linear, convolution and
embedding weight through float8 e4m3 with a per-tensor scale, and rounds
the input of every linear and convolution the same way at each call: the
numbers an fp8 path would multiply. ``fp8_ste_`` does the same to a module
that trains: its float32 weights stay, each forward multiplies their fp8
rounding, and the gradient passes the rounding straight through.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils import parametrize

FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float()
            * scale).to(x.dtype)


@torch.no_grad()
def fp8_(module: nn.Module) -> nn.Module:
    module.to(torch.bfloat16)
    kinds = (nn.Linear, nn.Conv2d, nn.ConvTranspose2d, nn.Conv1d)
    for m in module.modules():
        if isinstance(m, kinds + (nn.Embedding,)):
            m.weight.copy_(fp8_round(m.weight))
        if isinstance(m, kinds):
            m.register_forward_pre_hook(
                lambda _m, args: (fp8_round(args[0]),) + tuple(args[1:]))
    return module


class _FP8STE(nn.Module):
    def forward(self, w):
        return w + (fp8_round(w) - w).detach()


def fp8_ste_(module: nn.Module) -> nn.Module:
    kinds = (nn.Linear, nn.Conv2d, nn.ConvTranspose2d, nn.Conv1d)
    for m in list(module.modules()):
        if isinstance(m, kinds):
            parametrize.register_parametrization(m, "weight", _FP8STE())
            m.register_forward_pre_hook(lambda _m, args: (
                args[0] + (fp8_round(args[0]) - args[0]).detach(),)
                + tuple(args[1:]))
    return module
