"""Depth-Anything-V2-Small, the monocular relative-depth teacher
(``prometheus_tpu/models/depth_anything.py``).

The reference's frozen ``DepthAnythingForDepthEstimation``
(``Depth-Anything-V2-Small-hf``): a DINOv2 ViT-S/14 backbone (fused-qkv
blocks with layer scales; each tapped layer passes through the shared final
norm) feeding the DPT neck (reassemble with transposed-conv resizes, 3x3
bias-free convs, top-down fusion with pre-activation residual units and
align-corners bilinear upsampling) and the three-conv relative-depth head.
``DepthAnythingV2`` returns the disparity normalised per image to [0, 1].

``load_hf_da2_weights`` maps the HF state dict's names onto these modules
(the layout is already torch's) and returns the keys it did not use;
``make_depth_fn(weights_path=...)`` refuses a file with unused keys, as the
JAX loader does. Without weights the teacher is random (seeded): its
pseudo-depth is well-formed and uninformative. The submodules carry the
flax names, so ``weights.load_jax_params`` maps the JAX tree onto them.

The teacher computes in float32 (the JAX default) unless its weights are
cast; the position-embedding resize and the normalisation always run in
float32. Its attention (362 tokens for a 256^2 image) takes the plain path
of ``ops.attention``, as in the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import scaled_dot_product_attention

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resize_bilinear_ac(x: torch.Tensor, out_h: int,
                       out_w: int) -> torch.Tensor:
    """Bilinear resize of ``(B, C, H, W)`` with ``align_corners=True`` (the
    HF DPT fusion and head interpolations)."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


def resize_pos_embed(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """``(1, g*g, C)`` position embeddings of a ``g x g`` grid -> ``(1,
    gh*gw, C)``: ``jax.image.resize(method='bicubic')``, which is torch's
    antialiased bicubic with half-pixel centres, in float32."""
    g, c = math.isqrt(pos.shape[1]), pos.shape[2]
    if (gh, gw) == (g, g):
        return pos
    grid = pos.float().reshape(1, g, g, c).permute(0, 3, 1, 2)
    out = F.interpolate(grid, size=(gh, gw), mode="bicubic",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1).reshape(1, gh * gw, c).to(pos.dtype)


class ViTBlock(nn.Module):
    """DINOv2 block: pre-LN attention and MLP, each scaled by a layer
    scale."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(width, eps=1e-6)
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)
        self.ls1 = nn.Parameter(torch.ones(width))
        self.norm2 = nn.LayerNorm(width, eps=1e-6)
        self.mlp_fc1 = nn.Linear(width, 4 * width)
        self.mlp_fc2 = nn.Linear(4 * width, width)
        self.ls2 = nn.Parameter(torch.ones(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        qkv = self.qkv(self.norm1(x)).reshape(b, t, 3, self.heads,
                                              c // self.heads)
        attn = scaled_dot_product_attention(qkv[:, :, 0], qkv[:, :, 1],
                                            qkv[:, :, 2])
        x = x + self.proj(attn.reshape(b, t, c)) * self.ls1
        h = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + h * self.ls2


class DINOv2(nn.Module):
    """Patch tokens + CLS -> the tapped hidden states, each through the
    shared final norm (HF ``Dinov2Backbone`` with ``apply_layernorm``)."""

    def __init__(self, width: int = 384, layers: int = 12, heads: int = 6,
                 patch: int = 14, out_layers: tuple = (2, 5, 8, 11),
                 native_grid: int = 37):
        super().__init__()
        self.patch, self.layers = patch, layers
        self.out_layers = tuple(out_layers)
        self.patch_embed = nn.Conv2d(3, width, patch, stride=patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(torch.zeros(1, native_grid ** 2 + 1,
                                                  width))
        for i in range(layers):
            self.add_module(f"block_{i}", ViTBlock(width, heads))
        self.norm = nn.LayerNorm(width, eps=1e-6)

    def forward(self, x: torch.Tensor):
        """``(B, 3, H, W)`` normalised, H and W multiples of the patch ->
        ``([tapped (B, 1 + gh*gw, C)], (gh, gw))``."""
        B, _, H, W = x.shape
        gh, gw = H // self.patch, W // self.patch
        tok = self.patch_embed(x).flatten(2).transpose(1, 2)
        pos = self.pos_embed.to(tok.dtype)
        pos_patch = resize_pos_embed(pos[:, 1:], gh, gw)
        tokens = torch.cat([(self.cls_token.to(tok.dtype) + pos[:, :1])
                            .expand(B, 1, -1), tok + pos_patch], dim=1)
        outs = []
        for i in range(self.layers):
            tokens = getattr(self, f"block_{i}")(tokens)
            if i in self.out_layers:
                outs.append(self.norm(tokens))
        return outs, (gh, gw)


def conv(cin: int, cout: int, k: int, bias: bool = True) -> nn.Conv2d:
    """A stride-1 conv with flax's ``SAME`` padding (odd ``k``)."""
    return nn.Conv2d(cin, cout, k, padding=k // 2, bias=bias)


class PreActResidualUnit(nn.Module):
    """relu-conv-relu-conv plus the skip (HF
    ``DepthAnythingPreActResidualLayer``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = conv(channels, channels, 3)
        self.conv2 = conv(channels, channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class ReassembleLayer(nn.Module):
    """1x1 projection, then the factor's resize: ``ConvTranspose2d(k,
    stride=k)`` at 4 or 2, a stride-2 3x3 conv at 0.5, none at 1."""

    def __init__(self, width: int, channels: int, factor: float):
        super().__init__()
        self.projection = nn.Conv2d(width, channels, 1)
        if factor > 1:
            k = int(factor)
            self.resize = nn.ConvTranspose2d(channels, channels, k, stride=k)
        elif factor < 1:
            self.resize = nn.Conv2d(channels, channels, 3,
                                    stride=int(round(1 / factor)), padding=1)
        else:
            self.resize = nn.Identity()

    def forward(self, f: torch.Tensor) -> torch.Tensor:
        return self.resize(self.projection(f))


class DPTNeckHead(nn.Module):
    """The HF Depth-Anything neck (reassemble, the 3x3 convs, fusion deepest
    first) and its head."""

    def __init__(self, width: int = 384, fusion: int = 64,
                 head_hidden: int = 32,
                 neck_channels: tuple = (48, 96, 192, 384),
                 factors: tuple = (4, 2, 1, 0.5), patch: int = 14):
        super().__init__()
        self.patch, self.levels = patch, len(neck_channels)
        for i, (ch, fac) in enumerate(zip(neck_channels, factors)):
            self.add_module(f"reassemble_{i}",
                            ReassembleLayer(width, ch, fac))
            self.add_module(f"conv_{i}", conv(ch, fusion, 3, bias=False))
        for i in range(self.levels):
            if i < self.levels - 1:     # the deepest level has no residual
                self.add_module(f"fusion_{i}_rcu1",
                                PreActResidualUnit(fusion))
            self.add_module(f"fusion_{i}_rcu2", PreActResidualUnit(fusion))
            self.add_module(f"fusion_{i}_projection",
                            nn.Conv2d(fusion, fusion, 1))
        self.head_conv1 = conv(fusion, fusion // 2, 3)
        self.head_conv2 = conv(fusion // 2, head_hidden, 3)
        self.head_conv3 = nn.Conv2d(head_hidden, 1, 1)

    def forward(self, token_maps, grid) -> torch.Tensor:
        """Tapped states -> disparity ``(B, gh*patch, gw*patch)``, >= 0."""
        gh, gw = grid
        feats = []
        for i, t in enumerate(token_maps):
            f = t[:, 1:].transpose(1, 2).reshape(t.shape[0], -1, gh, gw)
            f = getattr(self, f"reassemble_{i}")(f)
            feats.append(getattr(self, f"conv_{i}")(f))
        x = None
        for i in reversed(range(self.levels)):
            if x is None:
                x = feats[i]
            else:
                x = x + getattr(self, f"fusion_{i}_rcu1")(feats[i])
            x = getattr(self, f"fusion_{i}_rcu2")(x)
            size = (feats[i - 1].shape[-2:] if i > 0
                    else (2 * x.shape[-2], 2 * x.shape[-1]))
            x = getattr(self, f"fusion_{i}_projection")(
                resize_bilinear_ac(x, *size))
        x = resize_bilinear_ac(self.head_conv1(x), gh * self.patch,
                               gw * self.patch)
        x = self.head_conv3(F.relu(self.head_conv2(x)))
        return F.relu(x[:, 0])


class DepthAnythingV2(nn.Module):
    def __init__(self, width: int = 384, layers: int = 12, heads: int = 6,
                 patch: int = 14, out_layers: tuple = (2, 5, 8, 11),
                 native_grid: int = 37, fusion: int = 64,
                 head_hidden: int = 32,
                 neck_channels: tuple = (48, 96, 192, 384)):
        super().__init__()
        self.patch = patch
        self.backbone = DINOv2(width, layers, heads, patch, out_layers,
                               native_grid)
        self.head = DPTNeckHead(width, fusion, head_hidden, neck_channels,
                                patch=patch)

    def forward(self, images: torch.Tensor,
                normalize: bool = True) -> torch.Tensor:
        """``images (B, 3, H, W)`` in [-1, 1] -> disparity ``(B, 1, H, W)``,
        min-max normalised per image (floor 1e-6) unless ``normalize`` is
        off; float32."""
        H, W = images.shape[-2:]
        x = images.float() * 0.5 + 0.5
        mean, std = (x.new_tensor(c)[:, None, None]
                     for c in (IMAGENET_MEAN, IMAGENET_STD))
        x = (x - mean) / std
        # edge padding to a multiple of the patch, cropped off the output
        x = F.pad(x, (0, -W % self.patch, 0, -H % self.patch),
                  mode="replicate")
        outs, grid = self.backbone(x.to(self.backbone.patch_embed.weight
                                        .dtype))
        disp = self.head(outs, grid)[:, :H, :W].float()
        if normalize:
            lo = disp.amin(dim=(1, 2), keepdim=True)
            hi = disp.amax(dim=(1, 2), keepdim=True)
            disp = (disp - lo) / torch.clamp_min(hi - lo, 1e-6)
        return disp[:, None]


def make_depth_fn(weights_path: str | None = None, *,
                  device: str | torch.device = "cuda", seed: int = 0):
    """``depth_fn(images (B, N, 3, H, W)) -> disparity (B, N, 1, H, W)``
    of a float32 DA2-Small on ``device``: the HF weights at
    ``weights_path`` (a ``KeyError`` if any tensor there goes unused), or
    seeded random weights. The network is ``depth_fn.model``."""
    from ..checkpoint import load_torch_state_dict
    from ..utils import resolve_device
    from ..weights import init_random_

    device = resolve_device(device)
    with torch.device("meta"):
        model = DepthAnythingV2()
    model.to_empty(device=device)
    init_random_(model, torch.Generator(device=device).manual_seed(seed))
    if weights_path:
        unmapped = load_hf_da2_weights(load_torch_state_dict(weights_path),
                                       model)
        if unmapped:
            raise KeyError(f"unmapped DepthAnything tensors: {unmapped[:10]}"
                           f" (+{max(0, len(unmapped) - 10)} more)")
    model.eval()

    @torch.no_grad()
    def depth_fn(images: torch.Tensor) -> torch.Tensor:
        B, N = images.shape[:2]
        disp = model(images.reshape((B * N,) + images.shape[2:]))
        return disp.reshape((B, N) + disp.shape[1:])

    depth_fn.model = model
    return depth_fn


def hf_da2_names(model: DepthAnythingV2) -> dict:
    """``{HF DepthAnythingForDepthEstimation name: this model's name}`` for
    every tensor ``model`` holds (q, k and v map to slices of ``qkv``, so
    they are listed under the ``qkv`` name with a ``#q``/``#k``/``#v``
    suffix)."""
    names = {}
    emb = "backbone.embeddings"
    names[f"{emb}.cls_token"] = "backbone.cls_token"
    names[f"{emb}.position_embeddings"] = "backbone.pos_embed"
    for p in ("weight", "bias"):
        names[f"{emb}.patch_embeddings.projection.{p}"] = \
            f"backbone.patch_embed.{p}"
        names[f"backbone.layernorm.{p}"] = f"backbone.norm.{p}"
    for i in range(model.backbone.layers):
        src, dst = f"backbone.encoder.layer.{i}", f"backbone.block_{i}"
        for p in ("weight", "bias"):
            for j, part in enumerate(("query", "key", "value")):
                names[f"{src}.attention.attention.{part}.{p}"] = \
                    f"{dst}.qkv.{p}#{j}"
            names[f"{src}.attention.output.dense.{p}"] = f"{dst}.proj.{p}"
            names[f"{src}.norm1.{p}"] = f"{dst}.norm1.{p}"
            names[f"{src}.norm2.{p}"] = f"{dst}.norm2.{p}"
            names[f"{src}.mlp.fc1.{p}"] = f"{dst}.mlp_fc1.{p}"
            names[f"{src}.mlp.fc2.{p}"] = f"{dst}.mlp_fc2.{p}"
        names[f"{src}.layer_scale1.lambda1"] = f"{dst}.ls1"
        names[f"{src}.layer_scale2.lambda1"] = f"{dst}.ls2"
    head = model.head
    n = head.levels
    for i in range(n):
        src, dst = f"neck.reassemble_stage.layers.{i}", f"head.reassemble_{i}"
        fsrc = f"neck.fusion_stage.layers.{n - 1 - i}"
        fdst = f"head.fusion_{i}"
        for p in ("weight", "bias"):
            names[f"{src}.projection.{p}"] = f"{dst}.projection.{p}"
            if not isinstance(getattr(head, f"reassemble_{i}").resize,
                              nn.Identity):
                names[f"{src}.resize.{p}"] = f"{dst}.resize.{p}"
            names[f"{fsrc}.projection.{p}"] = f"{fdst}_projection.{p}"
            for rcu, hf in (("rcu1", "residual_layer1"),
                            ("rcu2", "residual_layer2")):
                for c in (1, 2):
                    names[f"{fsrc}.{hf}.convolution{c}.{p}"] = (
                        f"{fdst}_{rcu}.conv{c}.{p}"
                        if hasattr(head, f"fusion_{i}_{rcu}") else None)
        names[f"neck.convs.{i}.weight"] = f"head.conv_{i}.weight"
    for c in (1, 2, 3):
        for p in ("weight", "bias"):
            names[f"head.conv{c}.{p}"] = f"head.head_conv{c}.{p}"
    return names


@torch.no_grad()
def load_hf_da2_weights(sd: dict, model: DepthAnythingV2) -> list:
    """Copy an HF ``DepthAnythingForDepthEstimation`` state dict into
    ``model`` (query, key and value concatenated into ``qkv``; the first
    fusion layer's ``residual_layer1``, which HF holds and never runs, is
    consumed without a target). Every tensor of ``model`` must be found.
    Returns the keys of ``sd`` left unused, ``mask_token`` and
    ``position_ids`` aside (loud, as the JAX loader is)."""
    targets = dict(model.named_parameters())
    parts: dict = {}
    used, loaded = set(), set()
    for hf, name in hf_da2_names(model).items():
        if hf not in sd:
            continue
        used.add(hf)
        if name is None:
            continue
        if "#" in name:
            name, j = name.split("#")
            parts.setdefault(name, {})[int(j)] = sd[hf]
            if len(parts[name]) < 3:
                continue
            value = torch.cat([parts[name][k] for k in range(3)])
        else:
            value = sd[hf]
        dst = targets[name]
        dst.copy_(value.reshape(dst.shape))
        loaded.add(name)
    missing = sorted(set(targets) - loaded)
    if missing:
        raise KeyError(f"no HF value for {len(missing)} tensors, e.g. "
                       f"{missing[:4]}")
    return [k for k in sd if k not in used
            and "mask_token" not in k and "position_ids" not in k]
