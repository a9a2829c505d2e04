# Frozen copy of prometheus_torch/models/unet_mv.py at commit 078c4a5; imports
# rewritten to this package, kernel A replaced by plain attention.
"""MultiViewUNet: SD-2.1-class U-Net with joint cross-view self-attention
(``prometheus_tpu/models/unet_mv.py``).

SD-2.1 topology: model_channels 320, channel_mult (1, 2, 4, 4), 2 res blocks
per level, spatial transformers (depth 1, linear proj, GEGLU ff, head dim
64, text context 1024) at downsample factors 1/2/4, time embed 320 -> 1280.
Inside self-attention the per-view token grids of all ``num_frames`` views
are flattened into one sequence so the views attend jointly; text
cross-attention stays per view. With a ``view_group`` (view-sharded
sampling and training, ``prometheus_tpu``'s ``view_axis``) ``num_frames``
counts this rank's views, and the joint sites gather K and V of every
rank's views along the token axis in rank order (``parallel.dist.
gather_tokens``); the sites ``disable_3d_attentions`` keeps 2-D stay
local. ``disable_3d_attentions`` (16 sites: 6
encoder, 1 middle, 9 decoder) keeps the highest-resolution sites 2-D.
Input and output NCHW ``(B*F, C, H, W)``.

With ``use_checkpoint`` (the JAX module's per-block ``nn.remat``, policy
``full``) each ``ResBlock`` and ``SpatialTransformer3D`` call of a module in
training mode with gradients enabled runs under
``torch.utils.checkpoint``: its activations are recomputed in the backward
(so kernel A runs twice at every attention site of a train step). Inference
(``torch.no_grad``, or a module in eval mode) runs the blocks directly.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .plain import scaled_dot_product_attention
from .plain import gather_tokens
from .layers import GroupNorm32, conv3x3, timestep_embedding, upsample2x


class TimeEmbed(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(cin, dim)
        self.fc2 = nn.Linear(dim, dim)

    def forward(self, t_emb):
        return self.fc2(F.silu(self.fc1(t_emb)))


class ResBlock(nn.Module):
    """LDM residual block with the timestep embedding added in between."""

    def __init__(self, cin: int, cout: int, emb_dim: int):
        super().__init__()
        self.in_norm = GroupNorm32(cin, eps=1e-5)
        self.in_conv = conv3x3(cin, cout)
        self.emb_proj = nn.Linear(emb_dim, cout)
        self.out_norm = GroupNorm32(cout, eps=1e-5)
        self.out_conv = conv3x3(cout, cout)
        self.skip = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, emb):
        h = self.in_conv(F.silu(self.in_norm(x)))
        h = h + self.emb_proj(F.silu(emb))[:, :, None, None]
        h = self.out_conv(F.silu(self.out_norm(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when ``context`` is None.

    ``kv``: precomputed ``(k, v)`` projections of the context (each
    ``(B, Tk, inner)``); the sampler computes the constant text K/V once per
    sample (``precompute_text_kv``) and ``to_k``/``to_v`` are skipped.
    ``gather_group``: K and V of every rank are gathered along the token
    axis (``Tk`` then exceeds ``Tq`` and the plain attention path runs, as
    JAX's XLA path does at ``Tq != Tk``).
    """

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: int | None = None):
        super().__init__()
        inner = heads * dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)

    def forward(self, x, context=None, kv=None, gather_group=None):
        b, tq, _ = x.shape
        q = self.to_q(x)
        if kv is not None:
            k, v = (a.to(q.dtype) for a in kv)
        else:
            ctx = x if context is None else context
            k, v = self.to_k(ctx), self.to_v(ctx)
        if gather_group is not None:
            k = gather_tokens(k, gather_group)
            v = gather_tokens(v, gather_group)
        tk = k.shape[1]
        out = scaled_dot_product_attention(
            q.reshape(b, tq, self.heads, self.dim_head),
            k.reshape(b, tk, self.heads, self.dim_head),
            v.reshape(b, tk, self.heads, self.dim_head))
        return self.to_out(out.reshape(b, tq, self.heads * self.dim_head))


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * dim_out)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)          # exact (erf) gelu


class BasicTransformerBlock3D(nn.Module):
    """Self-attention (joint over ``num_frames`` views, and over every
    rank's views with a ``view_group``) -> text cross-attention -> GEGLU
    feed-forward, each pre-LayerNorm."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff_geglu = GEGLU(dim, 4 * dim)
        self.ff_out = nn.Linear(4 * dim, dim)

    def forward(self, x, context, num_frames: int = 1, kv=None,
                view_group=None):
        bf, l, c = x.shape
        h = self.norm1(x)
        if num_frames > 1 or view_group is not None:
            # (b f) l c -> b (f l) c: the views attend jointly
            b = bf // num_frames
            h = self.attn1(h.reshape(b, num_frames * l, c),
                           gather_group=view_group).reshape(bf, l, c)
        else:
            h = self.attn1(h)
        x = x + h
        x = x + self.attn2(self.norm2(x), context, kv)
        return x + self.ff_out(self.ff_geglu(self.norm3(x)))


class SpatialTransformer3D(nn.Module):
    """GN -> linear proj_in -> transformer block(s) -> proj_out + skip."""

    def __init__(self, channels: int, heads: int, dim_head: int,
                 context_dim: int, depth: int = 1):
        super().__init__()
        inner = heads * dim_head
        self.depth = depth
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock3D(
                inner, heads, dim_head, context_dim))
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x, context, kv=None, num_frames: int = 1,
                view_group=None):
        """``num_frames == 1`` without ``view_group`` is 2-D (per-view)
        self-attention."""
        bf, c, hh, ww = x.shape
        h = self.norm(x).flatten(2).transpose(1, 2)             # (BF, HW, C)
        h = self.proj_in(h)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(
                h, context, num_frames, kv[i] if kv is not None else None,
                view_group)
        h = self.proj_out(h)
        return x + h.transpose(1, 2).reshape(bf, c, hh, ww)


class UNetDownsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels, stride=2)

    def forward(self, x):
        return self.conv(x)


class UNetUpsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels)

    def forward(self, x):
        return self.conv(upsample2x(x))


def attention_site_names(channel_mult=(1, 2, 4, 4), num_res_blocks=2,
                         attention_ds=(1, 2, 4)) -> list[str]:
    """Attention-site names in the U-Net's traversal order (the order that
    indexes ``disable_3d_attentions``)."""
    names = []
    ds = 1
    for level in range(len(channel_mult)):
        for j in range(num_res_blocks):
            if ds in attention_ds:
                names.append(f"down_{level}_attn_{j}")
        if level != len(channel_mult) - 1:
            ds *= 2
    names.append("mid_attn")
    for level in reversed(range(len(channel_mult))):
        for j in range(num_res_blocks + 1):
            if ds in attention_ds:
                names.append(f"up_{level}_attn_{j}")
        if level != 0:
            ds //= 2
    return names


class MultiViewUNet(nn.Module):
    """The MV-LDM denoiser. Input and output NCHW ``(B*F, C, H, W)``."""

    def __init__(self, in_channels: int = 15, out_channels: int = 15,
                 model_channels: int = 320, num_res_blocks: int = 2,
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 attention_ds: Sequence[int] = (1, 2, 4),
                 num_head_channels: int = 64, context_dim: int = 1024,
                 transformer_depth: int = 1,
                 disable_3d_attentions: Sequence[int] = (
                     1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1),
                 use_checkpoint: bool = True):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        self.model_channels = model_channels
        self.channel_mult = tuple(channel_mult)
        self.num_res_blocks = num_res_blocks
        self.attention_ds = tuple(attention_ds)
        self.transformer_depth = transformer_depth
        emb_dim = 4 * model_channels
        self.time_embed = TimeEmbed(model_channels, emb_dim)
        sites = attention_site_names(channel_mult, num_res_blocks,
                                     attention_ds)
        self.is_3d = {name: not (i < len(disable_3d_attentions)
                                 and disable_3d_attentions[i])
                      for i, name in enumerate(sites)}

        def attn(ch, name):
            self.add_module(name, SpatialTransformer3D(
                ch, ch // num_head_channels, num_head_channels, context_dim,
                depth=transformer_depth))

        # the traversal below mirrors forward(): ``self.plan`` lists the
        # steps, skip widths are tracked as in the JAX module
        self.conv_in = conv3x3(in_channels, model_channels)
        self.plan = []
        skips = [model_channels]
        ch, ds = model_channels, 1
        for level, mult in enumerate(channel_mult):
            for j in range(num_res_blocks):
                out = model_channels * mult
                self.add_module(f"down_{level}_res_{j}",
                                ResBlock(ch, out, emb_dim))
                ch = out
                self.plan.append(("res", f"down_{level}_res_{j}"))
                if ds in attention_ds:
                    attn(ch, f"down_{level}_attn_{j}")
                    self.plan.append(("attn", f"down_{level}_attn_{j}"))
                self.plan.append(("push", None))
                skips.append(ch)
            if level != len(channel_mult) - 1:
                self.add_module(f"down_{level}_downsample",
                                UNetDownsample(ch))
                self.plan.append(("down", f"down_{level}_downsample"))
                self.plan.append(("push", None))
                skips.append(ch)
                ds *= 2
        self.mid_res_1 = ResBlock(ch, ch, emb_dim)
        attn(ch, "mid_attn")
        self.mid_res_2 = ResBlock(ch, ch, emb_dim)
        self.plan += [("res", "mid_res_1"), ("attn", "mid_attn"),
                      ("res", "mid_res_2")]
        for level in reversed(range(len(channel_mult))):
            out = model_channels * channel_mult[level]
            for j in range(num_res_blocks + 1):
                self.plan.append(("pop", None))
                self.add_module(f"up_{level}_res_{j}",
                                ResBlock(ch + skips.pop(), out, emb_dim))
                ch = out
                self.plan.append(("res", f"up_{level}_res_{j}"))
                if ds in attention_ds:
                    attn(ch, f"up_{level}_attn_{j}")
                    self.plan.append(("attn", f"up_{level}_attn_{j}"))
            if level != 0:
                self.add_module(f"up_{level}_upsample", UNetUpsample(ch))
                self.plan.append(("up", f"up_{level}_upsample"))
                ds //= 2
        self.out_norm = GroupNorm32(ch, eps=1e-5)
        self.conv_out = conv3x3(ch, out_channels)

    def forward(self, x, timesteps, context, num_frames: int = 1,
                text_kv: dict | None = None, view_group=None):
        """``x (B*F, C, H, W)``, ``timesteps (B*F,)``, ``context (B*F, L,
        ctx_dim)``; ``text_kv``: ``{site: ((k, v), ...)}`` from
        ``precompute_text_kv``; ``view_group``: the F views are this rank's
        share of a scene whose joint sites span the group."""
        dtype = self.conv_in.weight.dtype
        remat = (self.use_checkpoint and self.training
                 and torch.is_grad_enabled())

        def run(block, *args):
            if remat:
                return checkpoint(block, *args, use_reentrant=False,
                                  preserve_rng_state=False)
            return block(*args)

        emb = self.time_embed(
            timestep_embedding(timesteps, self.model_channels).to(dtype))
        context = context.to(dtype)
        h = self.conv_in(x.to(dtype))
        skips = [h]
        for kind, name in self.plan:
            if kind == "push":
                skips.append(h)
            elif kind == "pop":
                h = torch.cat([h, skips.pop()], dim=1)
            elif kind == "res":
                h = run(getattr(self, name), h, emb)
            elif kind == "attn":
                kv = text_kv.get(name) if text_kv is not None else None
                is_3d = self.is_3d[name]
                h = run(getattr(self, name), h, context, kv,
                        num_frames if is_3d else 1,
                        view_group if is_3d else None)
            else:                                   # down / up
                h = getattr(self, name)(h)
        return self.conv_out(F.silu(self.out_norm(h)))


def precompute_text_kv(unet: MultiViewUNet, context: torch.Tensor) -> dict:
    """Project the constant text context through every site's ``attn2``
    ``to_k``/``to_v`` once, for reuse at every denoising step.

    ``context``: the per-view-repeated, CFG-stacked rows the U-Net will see,
    ``(B*F, L, ctx_dim)``. Returns ``{site: ((k, v), ...)}``, one pair per
    transformer depth.
    """
    out = {}
    for name in attention_site_names(unet.channel_mult, unet.num_res_blocks,
                                     unet.attention_ds):
        site = getattr(unet, name)
        pairs = []
        for d in range(unet.transformer_depth):
            blk = getattr(site, f"block_{d}").attn2
            ctx = context.to(blk.to_k.weight.dtype)
            pairs.append((blk.to_k(ctx), blk.to_v(ctx)))
        out[name] = tuple(pairs)
    return out
