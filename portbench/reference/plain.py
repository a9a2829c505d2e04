"""The plain stand-ins the frozen model copies import in place of the
port's kernel A and its process-group helpers: one process, no kernels."""
from __future__ import annotations

import torch


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention ``(B, Tq, H, D)`` -> ``(B, Tq, H, D)``: fp32
    logits and softmax, the weights cast to ``v.dtype``, in blocks of
    batch rows so that the logits stay under about 1 GiB."""
    scale = q.shape[-1] ** -0.5
    B, Tq, H, _ = q.shape
    rows = max(1, (1 << 28) // max(1, H * Tq * k.shape[1]))
    outs = []
    for b in range(0, B, rows):
        qb, kb, vb = q[b:b + rows], k[b:b + rows], v[b:b + rows]
        logits = torch.einsum("bqhd,bkhd->bhqk", qb, kb).float() * scale
        weights = torch.softmax(logits, dim=-1).to(vb.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", weights, vb))
    return torch.cat(outs)


def gather_tokens(x: torch.Tensor, group=None) -> torch.Tensor:
    if group is not None:
        raise ValueError("the reference runs in one process")
    return x


def get_rank(group=None) -> int:
    return 0
