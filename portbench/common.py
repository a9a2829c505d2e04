"""Pieces the drivers share: seeds, the prompt stream, the comparisons,
the FLOP count of a reference call on the meta device, and the recorder of
the attention shapes the port's kernels see."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
# a frozen copy (commit 078c4a5) of benchmarks/scene_benchmark80/prompts.txt
PROMPTS = HERE / "prompts.txt"


def sub_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed for one part of a run (a unit's noise, the cameras)."""
    x = int(seed) % (1 << 63)
    for p in parts:
        x = (x * 6364136223846793005 + 1442695040888963407 + int(p)) \
            % (1 << 63)
    return x


def generator(device, seed: int, *parts: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *parts))


class PromptStream:
    """Batches of prompts drawn from the 80 benchmark prompts: the seed
    picks a permutation, batches walk it in order and wrap around."""

    def __init__(self, seed: int, batch: int, path: Path = PROMPTS):
        self.prompts = [p.strip() for p in path.read_text().splitlines()
                        if p.strip()]
        rng = np.random.default_rng(sub_seed(seed, 1))
        self.order = rng.permutation(len(self.prompts))
        self.batch = batch

    def __call__(self, i: int) -> list[str]:
        n = len(self.order)
        return [self.prompts[self.order[(i * self.batch + j) % n]]
                for j in range(self.batch)]


def rel_max(got: torch.Tensor, ref: torch.Tensor) -> float:
    """``max|got - ref| / max|ref|``, float64 on the device."""
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def rel_rms(got: torch.Tensor, ref: torch.Tensor) -> float:
    """``rms(got - ref) / rms(ref)``, float64: a few ill-conditioned values
    (a quaternion of small norm normalised) do not set it."""
    got, ref = got.double(), ref.double()
    return float(((got - ref) ** 2).mean().sqrt()
                 / (ref ** 2).mean().sqrt().clamp_min(1e-30))


# the 18-vector of a camera: the c2w rotation, its translation, the
# focal lengths and principal point, the image size
CAMERA_BLOCKS = ((0, 1, 2, 4, 5, 6, 8, 9, 10), (3, 7, 11), (12, 13),
                 (14, 15))


def rel_cameras(got: torch.Tensor, ref: torch.Tensor) -> float:
    """``rel_max`` over each block of the ``(..., 18)`` camera vectors
    (rotation, translation, focal lengths, principal point), the largest
    of them; the image size must match exactly."""
    if not torch.equal(got[..., 16:].double(), ref[..., 16:].double()):
        return float("inf")
    return max(rel_max(got[..., list(b)], ref[..., list(b)])
               for b in CAMERA_BLOCKS)


def rms(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float(((got.double() - ref.double()) ** 2).mean().sqrt())


def meta_flops(fn) -> float:
    """The FLOPs ``torch.utils.flop_counter`` counts for ``fn()`` (a call
    on meta tensors)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


class AttentionShapes:
    """Records the ``(B, T, H, D)`` of every call of kernel A and A-bwd
    while on, by wrapping the port's ``ops.attention`` entry points."""

    def __init__(self):
        self.fwd, self.bwd = [], []
        self._saved = None

    def on(self):
        from prometheus_torch.ops import attention as at

        fwd, bwd = at.flash_attention_fwd, at.flash_attention_bwd
        self._saved = (fwd, bwd)

        def rec_fwd(q, k, v, with_lse=False):
            self.fwd.append(tuple(q.shape))
            return fwd(q, k, v, with_lse=with_lse)

        def rec_bwd(q, k, v, o, lse, do):
            self.bwd.append(tuple(q.shape))
            return bwd(q, k, v, o, lse, do)

        at.flash_attention_fwd, at.flash_attention_bwd = rec_fwd, rec_bwd

    def off(self):
        if self._saved is not None:
            from prometheus_torch.ops import attention as at

            at.flash_attention_fwd, at.flash_attention_bwd = self._saved
            self._saved = None


def finite(*tensors) -> torch.Tensor:
    """A 0-d bool tensor: every value of every tensor is finite."""
    flags = [torch.isfinite(t).all() for t in tensors]
    return torch.stack(flags).all()
