"""CLIP ViT-H/14 image tower, the image-to-3D conditioning
(``prometheus_tpu/models/clip_image.py``).

Reference images in [-1, 1] are resized to 224 by bicubic interpolation
with ``align_corners=True`` and antialiasing (on the [-1, 1] values), mapped
to [0, 1], CLIP-normalised and embedded; the result is the pooled CLS state
through ``post_ln`` and the bias-free ``visual_projection``: one
``proj_dim`` token per image, used in place of the text embeddings.
ViT-H/14: patch 14, width 1280, 32 layers, 16 heads, erf GELU
(``hidden_act="quick_gelu"`` for the OpenAI towers).

The submodules carry the flax names, so ``weights.load_jax_params`` maps the
JAX tree onto them. Attention goes through ``ops.attention.
scaled_dot_product_attention``: at 257 tokens that is the plain path, as in
the JAX package. The resize runs in float64, the normalisation in float32;
the tower computes in the dtype of its weights (on the card the pipeline's
bf16, like the CLIP text tower; the JAX tower's default is float32).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import scaled_dot_product_attention

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def resize_bicubic_torch(x: torch.Tensor, out_h: int,
                         out_w: int) -> torch.Tensor:
    """Resize ``(..., H, W)`` like the reference's ``F.interpolate(x, (224,
    224), mode='bicubic', align_corners=True, antialias=True)`` (the JAX
    package builds the same filter as a matrix). Computed in float64: in
    float32 torch's filter is off the exact result by up to 4.4e-5 at
    256 -> 224, the JAX matrix by 2.2e-7."""
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape((-1, 1, h, w)).double(), size=(out_h, out_w),
                      mode="bicubic", align_corners=True, antialias=True)
    return y.to(x.dtype).reshape(lead + (out_h, out_w))


class CLIPVisionLayer(nn.Module):
    def __init__(self, width: int, num_heads: int, hidden_act: str = "gelu"):
        super().__init__()
        self.num_heads, self.hidden_act = num_heads, hidden_act
        self.ln1 = nn.LayerNorm(width, eps=1e-5)
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)
        self.ln2 = nn.LayerNorm(width, eps=1e-5)
        self.fc1 = nn.Linear(width, 4 * width)
        self.fc2 = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        h = self.ln1(x)
        q, k, v = (lin(h).reshape(b, t, self.num_heads, c // self.num_heads)
                   for lin in (self.q_proj, self.k_proj, self.v_proj))
        x = x + self.out_proj(
            scaled_dot_product_attention(q, k, v).reshape(b, t, c))
        h = self.fc1(self.ln2(x))
        if self.hidden_act == "quick_gelu":      # OpenAI CLIP towers
            h = h * torch.sigmoid(1.702 * h)
        else:                                     # laion / OpenCLIP: erf
            h = F.gelu(h)
        return x + self.fc2(h)


class CLIPImageEncoder(nn.Module):
    """``images (B, 3, H, W)`` in [-1, 1] -> ``image_embeds (B, proj_dim)``
    (the reference's ``image_encoder(pixel_values).image_embeds``)."""

    def __init__(self, image_size: int = 224, patch: int = 14,
                 width: int = 1280, num_heads: int = 16, num_layers: int = 32,
                 proj_dim: int = 1024, hidden_act: str = "gelu"):
        super().__init__()
        self.image_size, self.num_layers = image_size, num_layers
        g = image_size // patch
        self.patch_embed = nn.Conv2d(3, width, patch, stride=patch,
                                     bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.position_embedding = nn.Parameter(torch.zeros(g * g + 1, width))
        self.pre_ln = nn.LayerNorm(width, eps=1e-5)
        for i in range(num_layers):
            self.add_module(f"layer_{i}",
                            CLIPVisionLayer(width, num_heads, hidden_act))
        self.post_ln = nn.LayerNorm(width, eps=1e-5)
        self.visual_projection = nn.Linear(width, proj_dim, bias=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        s = self.image_size
        x = resize_bicubic_torch(images.float(), s, s) * 0.5 + 0.5
        mean, std = (x.new_tensor(c)[:, None, None]
                     for c in (CLIP_MEAN, CLIP_STD))
        x = ((x - mean) / std).to(self.patch_embed.weight.dtype)
        tok = self.patch_embed(x).flatten(2).transpose(1, 2)  # (B, g*g, C)
        cls = self.class_embedding.to(tok.dtype).expand(tok.shape[0], 1, -1)
        x = torch.cat([cls, tok], dim=1) + self.position_embedding.to(
            tok.dtype)
        x = self.pre_ln(x)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        return self.visual_projection(self.post_ln(x[:, 0]))
