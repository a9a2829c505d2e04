"""LPIPS perceptual distance on a VGG16 trunk (``prometheus_tpu/models/
lpips.py``).

VGG16 conv features at relu1_2 / 2_2 / 3_3 / 4_3 / 5_3 of inputs shifted
and scaled like the LPIPS scaling layer, each unit-normalised over its
channels; the squared differences are weighted per channel by ``relu(lin_i)``
(initialised to ``1 / C``), summed over channels, averaged over the pixels,
summed over the five layers and averaged over the batch.

The official VGG16 and linear-head weights are not in the repository, so
``make_lpips_fn`` builds seeded random weights (random-feature LPIPS is still
a perceptual-style distance) unless it is given a torch checkpoint of them
(``weights_path``, read by ``load_torch_lpips_weights``); a JAX LPIPS tree
loads through ``weights.load_jax_params`` (conv HWIO -> OIHW, the ``lin{i}``
vectors as they are).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..weights import init_random_

# VGG16 conv plan: (out_channels, convs) per block
VGG_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """The VGG16 trunk; returns the five post-ReLU block outputs."""

    def __init__(self):
        super().__init__()
        cin = 3
        for b, (ch, n) in enumerate(VGG_BLOCKS):
            for c in range(n):
                self.add_module(f"block{b + 1}_conv{c + 1}",
                                nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch

    def forward(self, x):
        feats = []
        for b, (_, n) in enumerate(VGG_BLOCKS):
            for c in range(n):
                x = F.relu(getattr(self, f"block{b + 1}_conv{c + 1}")(x))
            feats.append(x)
            if b < len(VGG_BLOCKS) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats


class LPIPS(nn.Module):
    """``lpips(pred, target)`` over NCHW images in [-1, 1] -> a scalar."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, (ch, _) in enumerate(VGG_BLOCKS):
            setattr(self, f"lin{i}", nn.Parameter(torch.full((ch,), 1.0 / ch)))

    def forward(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        x = torch.cat([pred, target], dim=0)
        shift, scale = (torch.tensor(c, dtype=x.dtype, device=x.device)[
            :, None, None] for c in (SHIFT, SCALE))
        n = pred.shape[0]
        feats = self.vgg((x - shift) / scale)
        total = 0.0
        for i, f in enumerate(feats):
            f = f / torch.clamp_min(torch.linalg.vector_norm(
                f, dim=1, keepdim=True), 1e-10)
            diff = (f[:n] - f[n:]) ** 2
            w = F.relu(getattr(self, f"lin{i}"))
            total = total + (diff * w[:, None, None]).sum(1).mean((1, 2))
        return total.mean()


# torchvision VGG16's conv indices within ``features``, in block order
VGG_FEATURE_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


@torch.no_grad()
def load_torch_lpips_weights(path: str, module: LPIPS) -> LPIPS:
    """Load a torch LPIPS (+ VGG16) checkpoint into ``module`` in place
    (``prometheus_tpu/models/lpips.py::load_torch_lpips_weights``).

    Reads torchvision's ``features.<i>.weight`` / ``.bias`` conv keys, or
    the same under ``net.``, and lpips's ``lin<k>.model.1.weight`` or
    ``lins.<k>.model.1.weight`` heads (a ``(1, C, 1, 1)`` 1x1 conv, read as
    its ``C`` weights). Both are torch layouts, so values are copied as
    they are; a key that is absent leaves its tensor as it was, as in JAX.
    The file is unpickled: read only trusted files.
    """
    from ..checkpoint import load_torch_state_dict

    sd = load_torch_state_dict(path)
    names = [f"block{b + 1}_conv{c + 1}"
             for b, (_, n) in enumerate(VGG_BLOCKS) for c in range(n)]
    for idx, name in zip(VGG_FEATURE_INDEX, names):
        conv = getattr(module.vgg, name)
        for pre in ("", "net."):
            wk, bk = f"{pre}features.{idx}.weight", f"{pre}features.{idx}.bias"
            if wk in sd:
                conv.weight.copy_(sd[wk])
                conv.bias.copy_(sd[bk])
                break
    for k in range(len(VGG_BLOCKS)):
        for cand in (f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight"):
            if cand in sd:
                getattr(module, f"lin{k}").copy_(sd[cand].reshape(-1))
                break
    return module


def make_lpips_fn(generator: torch.Generator | None = None,
                  device: torch.device | str = "cpu",
                  weights_path: str | None = None):
    """A frozen LPIPS with seeded random VGG weights (``init_random_``) and
    heads at ``1 / C``, or the weights of the torch checkpoint at
    ``weights_path`` (``load_torch_lpips_weights``): ``lpips(pred, target)
    -> scalar`` for ``(B, 3, H, W)`` or ``(B, N, 3, H, W)`` images;
    gradients reach the images only. Returns ``(lpips_fn, module)``."""
    with torch.device("meta"):
        model = LPIPS()
    model.to_empty(device=device)
    g = generator or torch.Generator(device=device).manual_seed(0)
    init_random_(model.vgg, g)
    with torch.no_grad():
        for i, (ch, _) in enumerate(VGG_BLOCKS):
            getattr(model, f"lin{i}").fill_(1.0 / ch)
    if weights_path:
        load_torch_lpips_weights(weights_path, model)
    model.requires_grad_(False).eval()

    def lpips_fn(pred, target):
        if pred.dim() == 5:
            pred = pred.reshape((-1,) + pred.shape[2:])
            target = target.reshape((-1,) + target.shape[2:])
        return model(pred, target)

    return lpips_fn, model
