# Frozen copy of prometheus_torch/models/traj_dit.py at commit 078c4a5; imports
# rewritten to this package, kernel A replaced by plain attention.
"""TrajDiT: the text-to-camera-trajectory diffusion transformer
(``prometheus_tpu/models/traj_dit.py``).

29 camera tokens of 11 values (quaternion 4, translation 3, normalised
intrinsics 4) are denoised by a DiT whose blocks run text
cross-attention, then self-attention, then an MLP with tanh-approximate
gelu, each gated by a 9-way adaLN modulation of ``silu(t_embedder(t))``.
The attention runs over 29 and 77 tokens, so it takes the plain path.
Submodules carry the flax names, for ``weights.load_jax_params``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .quaternion import matrix_to_quaternion, quaternion_to_matrix
from .dit import (Mlp, MultiHeadCrossAttention, MultiHeadSelfAttention,
                  TimestepEmbedder, _norm)

TOKEN_DIM = 11


def camera_to_token(cameras: torch.Tensor) -> torch.Tensor:
    """``(B, N, 18)`` camera vectors -> ``(B, N, 11)`` tokens.

    The intrinsics are normalised as the reference does it: ``fx / H``,
    ``fy / W``, ``cx / H``, ``cy / W``.
    """
    B, N, _ = cameras.shape
    rt = cameras[..., :12].reshape(B, N, 3, 4)
    quat = matrix_to_quaternion(rt[..., :3, :3])
    fx, fy, cx, cy, H, W = (cameras[..., 12 + i] for i in range(6))
    intr = torch.stack([fx / H, fy / W, cx / H, cy / W], dim=-1)
    return torch.cat([quat, rt[..., :3, 3], intr], dim=-1)


def token_to_camera(tokens: torch.Tensor, image_size: int) -> torch.Tensor:
    """``(B, N, 11)`` tokens -> ``(B, N, 18)`` cameras at ``image_size``^2.

    Guards against a degenerate model: a quaternion of norm below 1e-4
    becomes the identity, and focal lengths are at least ``1e-3 * s``.
    """
    B, N, _ = tokens.shape
    quat = tokens[..., :4]
    qn = torch.linalg.norm(quat, dim=-1, keepdim=True)
    ident = tokens.new_tensor([1.0, 0.0, 0.0, 0.0])
    quat = torch.where(qn < 1e-4, ident, quat / torch.clamp_min(qn, 1e-4))
    rt = torch.cat([quaternion_to_matrix(quat), tokens[..., 4:7, None]],
                   dim=-1).reshape(B, N, 12)
    s = float(image_size)
    full = torch.full((B, N), s, dtype=tokens.dtype, device=tokens.device)
    intr = torch.stack([torch.clamp_min(tokens[..., 7], 1e-3) * s,
                        torch.clamp_min(tokens[..., 8], 1e-3) * s,
                        tokens[..., 9] * s, tokens[..., 10] * s, full, full],
                       dim=-1)
    return torch.cat([rt, intr], dim=-1)


class TrajDiTBlock(nn.Module):
    """cross-attention -> self-attention -> MLP, each adaLN gated."""

    def __init__(self, hidden: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.adaLN_modulation = nn.Linear(hidden, 9 * hidden)
        self.cattn = MultiHeadCrossAttention(hidden, num_heads)
        self.sattn = MultiHeadSelfAttention(hidden, num_heads)
        self.mlp = Mlp(hidden, int(hidden * mlp_ratio))

    def forward(self, x, y, c):
        (sh_ca, sc_ca, g_ca, sh_sa, sc_sa, g_sa,
         sh_m, sc_m, g_m) = self.adaLN_modulation(c).chunk(9, dim=-1)

        def mod(v, sh, sc):
            return _norm(v) * (1 + sc[:, None]) + sh[:, None]

        x = x + g_ca[:, None] * self.cattn(mod(x, sh_ca, sc_ca), y)
        x = x + g_sa[:, None] * self.sattn(mod(x, sh_sa, sc_sa))
        return x + g_m[:, None] * self.mlp(mod(x, sh_m, sc_m))


class TrajDiTModel(nn.Module):
    def __init__(self, hidden_size: int = 512, num_blocks: int = 8,
                 num_tokens: int = 29, num_heads: int = 8,
                 mlp_ratio: float = 4.0, text_dim: int = 1024):
        super().__init__()
        self.num_tokens = num_tokens
        self.y_embedder = nn.Linear(text_dim, hidden_size)
        self.in_block = nn.Linear(TOKEN_DIM, hidden_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, num_tokens, hidden_size))
        self.t_embedder = TimestepEmbedder(hidden_size)
        for i in range(num_blocks):
            self.add_module(f"block_{i}",
                            TrajDiTBlock(hidden_size, num_heads, mlp_ratio))
        self.num_blocks = num_blocks
        self.out_block = nn.Linear(hidden_size, TOKEN_DIM)

    @property
    def dtype(self) -> torch.dtype:
        return self.in_block.weight.dtype

    def forward(self, tokens_noisy: torch.Tensor,
                text_embeddings: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
        """tokens ``(B, 29, 11)``, text ``(B, L, text_dim)``, t ``(B,)`` ->
        the sample prediction ``(B, 29, 11)`` in the model's dtype."""
        y = self.y_embedder(text_embeddings.to(self.dtype))
        x = self.in_block(tokens_noisy.to(self.dtype)) + self.pos_embed
        c = F.silu(self.t_embedder(t))
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x, y, c)
        return self.out_block(x)
