"""Reference-torch -> port weight-name tables for the pretrained towers
(``prometheus_tpu/weight_maps.py``).

The tables cover the reference's checkpoint formats: the LDM-style SD U-Net
(``input_blocks`` / ``middle_block`` / ``output_blocks`` -> ``down_*`` /
``mid_*`` / ``up_*``), the LDM VAE (``encoder`` / ``decoder`` resnet and
attention stacks), the raydiff cross-view DiT with the GS decoder's conv
wrappers, transformers' ``CLIPTextModel`` and ``CLIPVisionModel``. Each
``map_*`` yields the JAX package's ``(torch_key, flax_path, kind)`` triples
unchanged, so a test compares the two packages' tables as lists.

``apply_weight_map`` writes a reference state dict into a port module by
name. The port's modules carry the flax names, so a flax destination path
becomes a port name by ``weights.py``'s rule (``Conv_0`` / ``GroupNorm_0``
drop out; ``kernel``, ``scale`` and ``embedding`` become ``weight``). Both
sides are torch layouts, so the value needs no transform for each kind but
one; there is no detour through a flax layout:

- ``conv``: ``(O, I, kh, kw)`` in both (``nn.Conv2d``), as it is;
- ``linear`` / ``linear_nb``: ``(O, I)`` in both (``nn.Linear``), as it is;
  ``linear_nb`` maps no bias;
- ``norm`` (GroupNorm) / ``ln`` (LayerNorm): the ``(C,)`` weight and bias,
  as they are;
- ``embed``: the ``(V, D)`` table (``nn.Embedding``), as it is;
- ``embed_raw``: an embedding's ``.weight`` into a raw parameter, as it is;
- ``raw``: a bare tensor (no ``.weight`` suffix) into a raw parameter, as
  it is;
- ``attn1x1``: the VAE attention's 1x1 conv ``(O, I, 1, 1)``, which the port
  (like flax) runs as a Dense layer: ``w.reshape(O, I)``.

``reference_state_dict`` is the inverse: a port module's tensors under the
reference names. The MV-LDM's channel padding (4 -> 15 conv in and out)
composes on top via ``checkpoint.pad_conv_*``.
"""
from __future__ import annotations

from typing import Iterator

import torch
from torch import nn

from .weights import _jax_name


# ---------------------------------------------------------------------------
# U-Net (LDM naming), channel_mult levels L with R res blocks each
# ---------------------------------------------------------------------------

def map_ldm_unet(num_levels: int = 4, num_res_blocks: int = 2,
                 attention_levels=(0, 1, 2)) -> Iterator[tuple]:
    def res_pairs(src: str, dst: str):
        yield f"{src}.in_layers.0", f"{dst}/in_norm/GroupNorm_0", "norm"
        yield f"{src}.in_layers.2", f"{dst}/in_conv", "conv"
        yield f"{src}.emb_layers.1", f"{dst}/emb_proj", "linear"
        yield f"{src}.out_layers.0", f"{dst}/out_norm/GroupNorm_0", "norm"
        yield f"{src}.out_layers.3", f"{dst}/out_conv", "conv"
        yield f"{src}.skip_connection", f"{dst}/skip", "conv"

    def attn_pairs(src: str, dst: str):
        yield f"{src}.norm", f"{dst}/norm/GroupNorm_0", "norm"
        yield f"{src}.proj_in", f"{dst}/proj_in", "linear"
        tb = f"{src}.transformer_blocks.0"
        db = f"{dst}/block_0"
        for a in ("attn1", "attn2"):
            yield f"{tb}.{a}.to_q", f"{db}/{a}/to_q", "linear_nb"
            yield f"{tb}.{a}.to_k", f"{db}/{a}/to_k", "linear_nb"
            yield f"{tb}.{a}.to_v", f"{db}/{a}/to_v", "linear_nb"
            yield f"{tb}.{a}.to_out.0", f"{db}/{a}/to_out", "linear"
        for n in ("norm1", "norm2", "norm3"):
            yield f"{tb}.{n}", f"{db}/{n}", "ln"
        yield f"{tb}.ff.net.0.proj", f"{db}/ff_geglu/proj", "linear"
        yield f"{tb}.ff.net.2", f"{db}/ff_out", "linear"
        yield f"{src}.proj_out", f"{dst}/proj_out", "linear"

    yield "time_embed.0", "time_embed/fc1", "linear"
    yield "time_embed.2", "time_embed/fc2", "linear"
    yield "input_blocks.0.0", "conv_in", "conv"

    idx = 1
    for level in range(num_levels):
        for j in range(num_res_blocks):
            yield from res_pairs(f"input_blocks.{idx}.0",
                                 f"down_{level}_res_{j}")
            if level in attention_levels:
                yield from attn_pairs(f"input_blocks.{idx}.1",
                                      f"down_{level}_attn_{j}")
            idx += 1
        if level != num_levels - 1:
            yield (f"input_blocks.{idx}.0.op",
                   f"down_{level}_downsample/conv", "conv")
            idx += 1

    yield from res_pairs("middle_block.0", "mid_res_1")
    yield from attn_pairs("middle_block.1", "mid_attn")
    yield from res_pairs("middle_block.2", "mid_res_2")

    idx = 0
    for level in reversed(range(num_levels)):
        for j in range(num_res_blocks + 1):
            yield from res_pairs(f"output_blocks.{idx}.0",
                                 f"up_{level}_res_{j}")
            sub = 1
            if level in attention_levels:
                yield from attn_pairs(f"output_blocks.{idx}.1",
                                      f"up_{level}_attn_{j}")
                sub = 2
            if j == num_res_blocks and level != 0:
                yield (f"output_blocks.{idx}.{sub}.conv",
                       f"up_{level}_upsample/conv", "conv")
            idx += 1

    yield "out.0", "out_norm/GroupNorm_0", "norm"
    yield "out.2", "conv_out", "conv"


# ---------------------------------------------------------------------------
# VAE (LDM naming)
# ---------------------------------------------------------------------------

def map_ldm_vae(num_levels: int = 4, num_res_blocks: int = 2,
                which: str = "both") -> Iterator[tuple]:
    def res_pairs(src: str, dst: str):
        yield f"{src}.norm1", f"{dst}/norm1/GroupNorm_0", "norm"
        yield f"{src}.conv1", f"{dst}/conv1/Conv_0", "conv"
        yield f"{src}.norm2", f"{dst}/norm2/GroupNorm_0", "norm"
        yield f"{src}.conv2", f"{dst}/conv2/Conv_0", "conv"
        yield f"{src}.nin_shortcut", f"{dst}/nin_shortcut/Conv_0", "conv"

    def attn_pairs(src: str, dst: str):
        yield f"{src}.norm", f"{dst}/norm/GroupNorm_0", "norm"
        for t in ("q", "k", "v", "proj_out"):
            yield f"{src}.{t}", f"{dst}/{t}", "attn1x1"

    if which in ("both", "encoder"):
        yield "encoder.conv_in", "encoder/conv_in/Conv_0", "conv"
        for lvl in range(num_levels):
            for j in range(num_res_blocks):
                yield from res_pairs(f"encoder.down.{lvl}.block.{j}",
                                     f"encoder/down_{lvl}_block_{j}")
            if lvl != num_levels - 1:
                yield (f"encoder.down.{lvl}.downsample.conv",
                       f"encoder/down_{lvl}_downsample/conv", "conv")
        yield from res_pairs("encoder.mid.block_1", "encoder/mid_block_1")
        yield from attn_pairs("encoder.mid.attn_1", "encoder/mid_attn_1")
        yield from res_pairs("encoder.mid.block_2", "encoder/mid_block_2")
        yield "encoder.norm_out", "encoder/norm_out/GroupNorm_0", "norm"
        yield "encoder.conv_out", "encoder/conv_out/Conv_0", "conv"
        yield "quant_conv", "quant_conv", "conv"

    if which in ("both", "decoder"):
        yield "post_quant_conv", "post_quant_conv", "conv"
        yield "decoder.conv_in", "decoder/conv_in/Conv_0", "conv"
        yield from res_pairs("decoder.mid.block_1", "decoder/mid_block_1")
        yield from attn_pairs("decoder.mid.attn_1", "decoder/mid_attn_1")
        yield from res_pairs("decoder.mid.block_2", "decoder/mid_block_2")
        for lvl in range(num_levels):  # decoder counts up.{L} top-down
            for j in range(num_res_blocks + 1):
                yield from res_pairs(f"decoder.up.{lvl}.block.{j}",
                                     f"decoder/up_{lvl}_block_{j}")
            if lvl != 0:
                yield (f"decoder.up.{lvl}.upsample.conv",
                       f"decoder/up_{lvl}_upsample/conv/Conv_0", "conv")
        yield "decoder.norm_out", "decoder/norm_out/GroupNorm_0", "norm"
        yield "decoder.conv_out", "decoder/conv_out/Conv_0", "conv"


# ---------------------------------------------------------------------------
# Cross-view DiT (raydiff naming, reference modules/ray_diff.py + the
# GSDecoder conv_in/conv_out wrappers from models/gs_decoder.py)
# ---------------------------------------------------------------------------

def map_raydiff_dit(depth: int = 16) -> Iterator[tuple]:
    yield "conv_in.conv", "conv_in/conv", "conv"
    yield "conv_out.conv", "conv_out/conv/Conv_0", "conv"
    yield "x_embedder.proj", "dit/x_embedder", "conv"
    yield "t_embedder.mlp.0", "dit/t_embedder/fc1", "linear"
    yield "t_embedder.mlp.2", "dit/t_embedder/fc2", "linear"
    for i in range(depth):
        src, dst = f"blocks.{i}", f"dit/block_{i}"
        yield f"{src}.adaLN_modulation.1", f"{dst}/adaLN_modulation", "linear"
        yield f"{src}.attn.qkv", f"{dst}/attn/qkv", "linear"
        yield f"{src}.attn.proj", f"{dst}/attn/proj", "linear"
        yield f"{src}.mlp.fc1", f"{dst}/mlp/fc1", "linear"
        yield f"{src}.mlp.fc2", f"{dst}/mlp/fc2", "linear"
    yield ("final_layer.adaLN_modulation.1",
           "dit/final_layer/adaLN_modulation", "linear")
    yield "final_layer.linear", "dit/final_layer/linear", "linear"


# ---------------------------------------------------------------------------
# CLIP text tower (transformers naming)
# ---------------------------------------------------------------------------

def map_clip_text(num_layers: int = 23) -> Iterator[tuple]:
    yield ("text_model.embeddings.token_embedding",
           "token_embedding", "embed")
    yield ("text_model.embeddings.position_embedding",
           "position_embedding", "embed_raw")
    for i in range(num_layers):
        src = f"text_model.encoder.layers.{i}"
        dst = f"layer_{i}"
        for t in ("q_proj", "k_proj", "v_proj", "out_proj"):
            yield f"{src}.self_attn.{t}", f"{dst}/attn/{t}", "linear"
        yield f"{src}.layer_norm1", f"{dst}/ln1", "ln"
        yield f"{src}.layer_norm2", f"{dst}/ln2", "ln"
        yield f"{src}.mlp.fc1", f"{dst}/mlp/fc1", "linear"
        yield f"{src}.mlp.fc2", f"{dst}/mlp/fc2", "linear"
    yield "text_model.final_layer_norm", "final_ln", "ln"


# ---------------------------------------------------------------------------
# CLIP vision tower (transformers CLIPVisionModelWithProjection naming;
# reference mv_ldm.py:72-82 loads it for the image-to-3D task)
# ---------------------------------------------------------------------------

def map_clip_vision(num_layers: int = 32) -> Iterator[tuple]:
    emb = "vision_model.embeddings"
    yield f"{emb}.patch_embedding", "patch_embed", "conv"
    yield f"{emb}.class_embedding", "class_embedding", "raw"
    yield f"{emb}.position_embedding", "position_embedding", "embed_raw"
    # transformers' attribute really is spelled "pre_layrnorm"
    yield "vision_model.pre_layrnorm", "pre_ln", "ln"
    for i in range(num_layers):
        src = f"vision_model.encoder.layers.{i}"
        dst = f"layer_{i}"
        for t in ("q_proj", "k_proj", "v_proj", "out_proj"):
            yield f"{src}.self_attn.{t}", f"{dst}/{t}", "linear"
        yield f"{src}.layer_norm1", f"{dst}/ln1", "ln"
        yield f"{src}.layer_norm2", f"{dst}/ln2", "ln"
        yield f"{src}.mlp.fc1", f"{dst}/fc1", "linear"
        yield f"{src}.mlp.fc2", f"{dst}/fc2", "linear"
    yield "vision_model.post_layernorm", "post_ln", "ln"
    yield "visual_projection", "visual_projection", "linear_nb"


# ---------------------------------------------------------------------------
# Generic applier
# ---------------------------------------------------------------------------

def expected_torch_keys(pairs) -> set[str]:
    """All torch state-dict keys a mapping table can consume (for coverage
    checks: ``sd.keys() - expected_torch_keys(pairs)`` should be empty)."""
    keys = set()
    for src, _dst, kind in pairs:
        if kind == "raw":
            keys.add(src)
        else:
            keys.add(f"{src}.weight")
            keys.add(f"{src}.bias")
    return keys


def port_name(path: str) -> str:
    """A flax path (``a/b/kernel``) -> the port's tensor name
    (``a.b.weight``)."""
    return _jax_name(tuple(path.split("/")))[0]


@torch.no_grad()
def apply_weight_map(sd: dict, pairs, module: nn.Module,
                     prefix: str = "") -> tuple[int, list[str], list[str]]:
    """Write reference-torch tensors into ``module``'s parameters and
    buffers, in place, cast to each target's dtype on its device.

    Returns ``(n_mapped, missing, unassigned)`` as the JAX package does:
    ``missing`` lists table sources absent from ``sd`` whose destination
    exists (gaps in the checkpoint), ``unassigned`` lists flax destination
    paths of present sources that the module lacks (gaps in the module or
    the table). Both are empty for a verified conversion. A shape that
    differs raises ``ValueError`` naming the path.
    """
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    mapped, missing, unassigned = 0, [], []

    def put(path: str, value) -> None:
        nonlocal mapped
        name = port_name(path)
        if name not in targets:
            unassigned.append(path)
            return
        dst = targets[name]
        value = torch.as_tensor(value)
        if tuple(dst.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {path}: {tuple(dst.shape)} "
                             f"vs {tuple(value.shape)}")
        dst.copy_(value)
        mapped += 1

    def exists(path: str) -> bool:
        return port_name(path) in targets

    for src, dst, kind in pairs:
        dst = prefix + dst
        if kind in ("conv", "attn1x1", "linear", "linear_nb"):
            wk, bk = f"{src}.weight", f"{src}.bias"
            if wk not in sd:
                if exists(f"{dst}/kernel"):
                    missing.append(src)
                continue
            w = torch.as_tensor(sd[wk])
            if kind == "attn1x1":   # 1x1 conv consumed by a Dense layer
                w = w.reshape(w.shape[0], w.shape[1])
            put(f"{dst}/kernel", w)
            if kind != "linear_nb" and bk in sd:
                put(f"{dst}/bias", sd[bk])
        elif kind in ("norm", "ln"):
            wk = f"{src}.weight"
            if wk not in sd:
                if exists(f"{dst}/scale"):
                    missing.append(src)
                continue
            put(f"{dst}/scale", sd[wk])
            if f"{src}.bias" in sd:
                put(f"{dst}/bias", sd[f"{src}.bias"])
        elif kind in ("embed", "embed_raw"):
            leaf = f"{dst}/embedding" if kind == "embed" else dst
            wk = f"{src}.weight"
            if wk not in sd:
                if exists(leaf):
                    missing.append(src)
                continue
            put(leaf, sd[wk])
        elif kind == "raw":     # bare tensor (no .weight suffix), verbatim
            if src not in sd:
                if exists(dst):
                    missing.append(src)
                continue
            put(dst, sd[src])
        else:
            raise ValueError(kind)
    return mapped, missing, unassigned


@torch.no_grad()
def reference_state_dict(module: nn.Module, pairs,
                         prefix: str = "") -> dict:
    """The inverse of ``apply_weight_map``: ``module``'s tensors under the
    table's reference names (float32 copies on the CPU; ``attn1x1`` back to
    ``(O, I, 1, 1)``), for every entry whose destination exists. Checks a
    table's coverage without a published file, and writes port weights in
    the reference's layout."""
    own = dict(module.named_parameters())
    own.update(module.named_buffers())

    def get(path: str):
        t = own.get(port_name(prefix + path))
        return None if t is None else t.detach().float().cpu().clone()

    sd = {}
    for src, dst, kind in pairs:
        if kind in ("conv", "attn1x1", "linear", "linear_nb"):
            w = get(f"{dst}/kernel")
            if w is None:
                continue
            sd[f"{src}.weight"] = w[:, :, None, None] if kind == "attn1x1" \
                else w
            b = get(f"{dst}/bias")
            if b is not None and kind != "linear_nb":
                sd[f"{src}.bias"] = b
        elif kind in ("norm", "ln"):
            w = get(f"{dst}/scale")
            if w is None:
                continue
            sd[f"{src}.weight"] = w
            b = get(f"{dst}/bias")
            if b is not None:
                sd[f"{src}.bias"] = b
        elif kind in ("embed", "embed_raw"):
            w = get(f"{dst}/embedding" if kind == "embed" else dst)
            if w is not None:
                sd[f"{src}.weight"] = w
        elif kind == "raw":
            w = get(dst)
            if w is not None:
                sd[src] = w
    return sd
