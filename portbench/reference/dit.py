# Frozen copy of prometheus_torch/models/dit.py at commit 078c4a5; imports
# rewritten to this package, kernel A replaced by plain attention.
"""DiT primitives: adaLN blocks, the timestep embedder, self- and
cross-attention and sinusoid tables (``prometheus_tpu/models/dit.py``), as
the GS decoder's cross-view DiT and TrajDiT use them (tanh-approximate gelu
in both)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .plain import scaled_dot_product_attention
from .plain import gather_tokens
from .layers import timestep_embedding


def sinusoid_table(n_position: int, d_hid: int, base: float) -> np.ndarray:
    """Interleaved sin/cos position table ``(n_position, d_hid)``."""
    pos = np.arange(n_position)[:, None]
    dim = np.arange(d_hid)[None, :]
    angle = pos / np.power(base, 2 * (dim // 2) / d_hid)
    table = np.where(dim % 2 == 0, np.sin(angle), np.cos(angle))
    return table.astype(np.float32)


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int, freq_size: int = 256):
        super().__init__()
        self.freq_size = freq_size
        self.fc1 = nn.Linear(freq_size, hidden_size)
        self.fc2 = nn.Linear(hidden_size, hidden_size)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(t, self.freq_size).to(self.fc1.weight.dtype)
        return self.fc2(F.silu(self.fc1(emb)))


def modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def _norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine, eps 1e-6."""
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, hidden: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(hidden, 3 * hidden, bias=qkv_bias)
        self.proj = nn.Linear(hidden, hidden)

    def forward(self, x, gather_group=None):
        """``gather_group``: K and V of every rank's tokens are gathered
        along the token axis in rank order (view-sharded decoding)."""
        b, t, c = x.shape
        d = c // self.num_heads
        q, k, v = self.qkv(x).reshape(b, t, 3, self.num_heads, d).unbind(2)
        if gather_group is not None:
            k = gather_tokens(k, gather_group)
            v = gather_tokens(v, gather_group)
        out = scaled_dot_product_attention(q, k, v)
        return self.proj(out.reshape(b, t, c))


class MultiHeadCrossAttention(nn.Module):
    """Queries from ``x``, keys and values from a ``context`` of the same
    width and another length: always the plain attention path."""

    def __init__(self, hidden: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.to_q = nn.Linear(hidden, hidden)
        self.to_k = nn.Linear(hidden, hidden)
        self.to_v = nn.Linear(hidden, hidden)
        self.proj = nn.Linear(hidden, hidden)

    def forward(self, x, context):
        b, t, c = x.shape
        d = c // self.num_heads
        split = lambda y: y.reshape(b, y.shape[1], self.num_heads, d)
        out = scaled_dot_product_attention(split(self.to_q(x)),
                                           split(self.to_k(context)),
                                           split(self.to_v(context)))
        return self.proj(out.reshape(b, t, c))


class Mlp(nn.Module):
    def __init__(self, hidden: int, mlp_hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp_hidden)
        self.fc2 = nn.Linear(mlp_hidden, hidden)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DiTBlock(nn.Module):
    """adaLN-modulated transformer block (no text cross-attention)."""

    def __init__(self, hidden: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.adaLN_modulation = nn.Linear(hidden, 6 * hidden)
        self.attn = MultiHeadSelfAttention(hidden, num_heads)
        self.mlp = Mlp(hidden, int(hidden * mlp_ratio))

    def forward(self, x, c, gather_group=None):
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = self.adaLN_modulation(
            F.silu(c)).chunk(6, dim=-1)
        x = x + g_a[:, None, :] * self.attn(modulate(_norm(x), sh_a, sc_a),
                                            gather_group)
        return x + g_m[:, None, :] * self.mlp(modulate(_norm(x), sh_m, sc_m))


class FinalLayer(nn.Module):
    """adaLN-modulated output projection."""

    def __init__(self, hidden: int, out_dim: int):
        super().__init__()
        self.adaLN_modulation = nn.Linear(hidden, 2 * hidden)
        self.linear = nn.Linear(hidden, out_dim)

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(F.silu(c)).chunk(2, dim=-1)
        return self.linear(modulate(_norm(x), shift, scale))
