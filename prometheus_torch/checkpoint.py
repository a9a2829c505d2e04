"""Train-state checkpoints in a torch format (the counterpart of
``prometheus_tpu/checkpoint.py``'s Orbax save and resume-latest).

``save_checkpoint`` writes ``<ckpt_dir>/step_{step:09d}/state.pt`` holding
the step, the module's state dict (parameters and buffers, the EMANorm
magnitudes among them), the optimizer's state dict (a bf16 first moment
stays bf16), the EMA and the module's widths (``init_kwargs``), and keeps
the newest ``keep`` checkpoints. A checkpoint is written under a
temporary name and renamed, so a cut run never leaves a partial
``step_*`` directory. Over a process group every rank calls both: the
file is the same whole, unsharded one whatever the sharding (under
``--param_sharding fsdp`` the optimizer's moments and the EMA are gathered
first), rank 0 alone writes it, and ``restore_checkpoint`` reads it on
every rank and keeps each rank's slices, so a checkpoint moves between any
number of ranks.

``load_torch_state_dict`` reads a foreign torch checkpoint (a published
network's weights) into a flat dict of tensors.

The release bundle (``tools/create_final_ckpt.py``'s counterpart): a
directory holding one ``bundle.pt`` with the ``mvldm``, ``gsdecoder`` and
``traj`` module state dicts (buffers included) and, under ``widths``, the
constructor arguments each module was built with (``weights.
random_module`` records them). ``save_bundle`` / ``write_bundle`` write
it, ``load_bundle`` loads it strictly into a pipeline of the same widths,
``bundle_widths`` reads the widths to build one. A file, not a directory,
is the reference's published ``full.ckpt``: ``split_full_ckpt`` and
``convert_bundle`` convert it through ``weight_maps.py``'s tables, and
``reference_bundle`` writes a pipeline back into that layout.
"""
from __future__ import annotations

import os
import re
import shutil

import numpy as np
import torch

from .parallel import full_ema_params
from .parallel.dist import barrier, is_main_process

STATE_FILE = "state.pt"


def list_checkpoints(ckpt_dir: str) -> list[int]:
    """The steps of the checkpoints in ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(ckpt_dir)
                  if (m := re.fullmatch(r"step_(\d+)", name)))


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The newest checkpoint's directory (resume-latest), or None."""
    steps = list_checkpoints(ckpt_dir)
    return (os.path.join(ckpt_dir, f"step_{steps[-1]:09d}") if steps
            else None)


def _optimizer_state(state, convert) -> dict:
    """The optimizer's state dict with ``convert(name, tensor)`` applied
    to the moments of each sharded parameter (the optimizer holds
    ``state.sharding.shards`` in their order)."""
    sd = state.optimizer.state_dict()
    sharding = state.sharding
    if sharding is None:
        return sd
    names = list(sharding.shards)
    sd["state"] = {i: {k: convert(names[i], v)
                       if k in ("exp_avg", "exp_avg_sq") else v
                       for k, v in st.items()}
                   for i, st in sd["state"].items()}
    return sd


def save_checkpoint(ckpt_dir: str, state, step: int, keep: int = 3) -> str:
    """Write ``state`` (a ``TrainState``) as ``step_{step:09d}``; returns
    its path. Every rank calls it; rank 0 writes."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    gather = state.sharding.gather if state.sharding is not None else None
    optimizer = _optimizer_state(state, gather)
    ema = state.full_ema()
    if is_main_process():
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"step": state.step, "model": state.model.state_dict(),
                    "optimizer": optimizer, "ema": ema,
                    "widths": getattr(state.model, "init_kwargs", None)},
                   os.path.join(tmp, STATE_FILE))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        if keep > 0:
            for s in list_checkpoints(ckpt_dir)[:-keep]:
                shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                              ignore_errors=True)
    barrier()
    return path


def restore_checkpoint(path: str, state=None):
    """Read the checkpoint at ``path`` (a ``step_*`` directory) onto the
    CPU. With a ``TrainState``, load it in place (module, optimizer, EMA,
    step; the tensors go to their targets' devices) and return the state;
    without one, return the raw dict."""
    raw = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                     weights_only=True)
    if state is None:
        return raw
    state.model.load_state_dict(raw["model"])
    sharding = state.sharding
    local = ((lambda n, v: sharding.local(n, v).clone())
             if sharding is not None else (lambda n, v: v))
    if sharding is not None:
        sharding.reload()
        names = list(sharding.shards)
        raw["optimizer"]["state"] = {
            i: {k: local(names[i], v) if k in ("exp_avg", "exp_avg_sq")
                else v for k, v in st.items()}
            for i, st in raw["optimizer"]["state"].items()}
    state.optimizer.load_state_dict(raw["optimizer"])
    with torch.no_grad():
        for name, value in raw["ema"].items():
            state.ema_params[name].copy_(local(name, value))
    state.step = int(raw["step"])
    return state


def load_ema_weights_(module: torch.nn.Module, path: str) -> None:
    """Load a checkpoint's module state (buffers included) into ``module``,
    then its EMA weights over the parameters the EMA tracks (the final
    weights a stage-1 decoder is used with). ``path`` is a ``step_*``
    directory or a checkpoint directory, whose newest checkpoint is read."""
    if not os.path.exists(os.path.join(path, STATE_FILE)):
        latest = latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no checkpoint at {path}")
        path = latest
    raw = restore_checkpoint(path)
    module.load_state_dict(raw["model"])
    with torch.no_grad():
        for name, value in full_ema_params(module, raw["ema"]).items():
            module.get_parameter(name).copy_(value)


def load_torch_state_dict(path: str, key: str | None = None) -> dict:
    """A torch checkpoint -> ``{name: tensor}`` on the CPU, floating tensors
    as float32 (``prometheus_tpu/checkpoint.py::load_torch_state_dict``).
    ``key`` picks an entry of the file first; a ``state_dict`` entry is
    unwrapped. The file is unpickled: read only trusted files."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if key is not None:
        blob = blob[key]
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    return {k: v.float() if v.is_floating_point() else v
            for k, v in blob.items() if isinstance(v, torch.Tensor)}


# ---------------------------------------------------------------------------
# The published full.ckpt bundle (the reference's create_finalckpt layout:
# {'traj': state_dict, 'decoder': {'state_dict': ...}, 'mvldm':
# {'state_dict': ...}}) -> the port's modules
# ---------------------------------------------------------------------------

def split_full_ckpt(path: str) -> dict[str, dict]:
    """Split a ``full.ckpt`` bundle into per-tower state dicts of CPU
    tensors, floating ones as float32. The file is unpickled
    (``weights_only=False``, as the reference wrote it with its training
    objects): read only trusted files."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    towers = {}
    for name in ("traj", "decoder", "mvldm"):
        sub = blob[name]
        if isinstance(sub, dict) and "state_dict" in sub:
            sub = sub["state_dict"]
        towers[name] = {k: v.float() if v.is_floating_point() else v
                        for k, v in sub.items() if isinstance(v, torch.Tensor)}
    return towers


# TrajDiT state-dict names -> flax paths of the TrajDiT model (the port
# carries the same names)
TRAJ_KEYS = {
    "in_block.weight": "in_block/kernel",
    "in_block.bias": "in_block/bias",
    "out_block.weight": "out_block/kernel",
    "out_block.bias": "out_block/bias",
    "pos_embed": "pos_embed",
    "y_embedder.weight": "y_embedder/kernel",
    "y_embedder.bias": "y_embedder/bias",
    "t_embedder.0.mlp.0.weight": "t_embedder/fc1/kernel",
    "t_embedder.0.mlp.0.bias": "t_embedder/fc1/bias",
    "t_embedder.0.mlp.2.weight": "t_embedder/fc2/kernel",
    "t_embedder.0.mlp.2.bias": "t_embedder/fc2/bias",
}
# the same within ``blocks.<i>.`` -> ``block_<i>/``; the reference's
# CrossAttention names its projections q / k / v (qkv_bias=True)
TRAJ_BLOCK_KEYS = {
    "adaLN_modulation.0.weight": "adaLN_modulation/kernel",
    "adaLN_modulation.0.bias": "adaLN_modulation/bias",
    "cattn.q.weight": "cattn/to_q/kernel",
    "cattn.q.bias": "cattn/to_q/bias",
    "cattn.k.weight": "cattn/to_k/kernel",
    "cattn.k.bias": "cattn/to_k/bias",
    "cattn.v.weight": "cattn/to_v/kernel",
    "cattn.v.bias": "cattn/to_v/bias",
    "cattn.proj.weight": "cattn/proj/kernel",
    "cattn.proj.bias": "cattn/proj/bias",
    "sattn.qkv.weight": "sattn/qkv/kernel",
    "sattn.qkv.bias": "sattn/qkv/bias",
    "sattn.proj.weight": "sattn/proj/kernel",
    "sattn.proj.bias": "sattn/proj/bias",
    "mlp.fc1.weight": "mlp/fc1/kernel",
    "mlp.fc1.bias": "mlp/fc1/bias",
    "mlp.fc2.weight": "mlp/fc2/kernel",
    "mlp.fc2.bias": "mlp/fc2/bias",
}


def map_trajdit_key(k: str) -> str | None:
    """A TrajDiT state-dict name -> its flax path, or None."""
    if k in TRAJ_KEYS:
        return TRAJ_KEYS[k]
    m = re.match(r"blocks\.(\d+)\.(.*)", k)
    if m and m.group(2) in TRAJ_BLOCK_KEYS:
        return f"block_{m.group(1)}/{TRAJ_BLOCK_KEYS[m.group(2)]}"
    return None


@torch.no_grad()
def convert_tower(sd: dict, mapper, module: torch.nn.Module,
                  prefix: str = "") -> tuple[int, list[str]]:
    """Write ``sd`` into ``module`` through ``mapper`` (a state-dict name ->
    a flax path, or None), in place; returns ``(mapped_count,
    unmapped_keys)``. Reference and port tensors share the torch layouts,
    so values are copied as they are (cast to the target's dtype); a shape
    that differs raises ``ValueError``."""
    from .weight_maps import port_name

    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    mapped, unmapped = 0, []
    for k, v in sd.items():
        path = mapper(k)
        dst = targets.get(port_name(prefix + path)) if path else None
        if dst is None:
            unmapped.append(k)
            continue
        if tuple(dst.shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {prefix + path}: "
                             f"{tuple(dst.shape)} vs {tuple(v.shape)}")
        dst.copy_(v)
        mapped += 1
    return mapped, unmapped


def _strip_prefix(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _normalize_gs_vae_sd(sd: dict) -> tuple[dict, dict]:
    """Undo the reference's EMANorm Sequential wrapping (the upsample conv
    becomes ``conv.0`` and a ``conv.1.magnitude_ema`` buffer appears).
    Returns (renamed sd, {level: magnitude_ema})."""
    out, ema = {}, {}
    for k, v in sd.items():
        m = re.fullmatch(
            r"decoder\.up\.(\d+)\.upsample\.conv\.0\.(weight|bias)", k)
        if m:
            out[f"decoder.up.{m.group(1)}.upsample.conv.{m.group(2)}"] = v
            continue
        m = re.fullmatch(r"decoder\.up\.(\d+)\.upsample\.conv\.1"
                         r"\.magnitude_ema", k)
        if m:
            ema[int(m.group(1))] = v
            continue
        out[k] = v
    return out, ema


def _vae_levels(vae: torch.nn.Module) -> int:
    return sum(1 for n, _ in vae.decoder.named_children()
               if n.endswith("_block_0"))


@torch.no_grad()
def convert_bundle(towers: dict, pipe) -> dict:
    """Write ``split_full_ckpt``'s towers into ``pipe`` (a
    ``PrometheusPipeline``) in place, cast to its dtype on its device.

    Returns JAX's per-tower report: ``traj`` ``{mapped, unmapped}``;
    ``mvldm`` and ``decoder`` ``{mapped, missing, unassigned, skipped}``,
    ``missing`` the checkpoint's gaps, ``unassigned`` the module's (flax
    paths), ``skipped`` the source keys outside the consumed prefixes (the
    frozen ``model.decoder_2d.*`` copy the reference's decoder carries).
    The EMANorm ``magnitude_ema`` buffers count among the decoder's mapped
    tensors. The trained bundle already holds the MV-LDM's 15-channel
    convs: no padding happens here. A decoder built without the cross-view
    DiT or the EMANorms takes the same tables, as in JAX: the checkpoint's
    DiT tensors and magnitudes land in ``unassigned``, and a ``conv_in`` of
    the DiT's width raises ``ValueError`` at ``vae/decoder/conv_in``.
    """
    from .weight_maps import (apply_weight_map, map_clip_text, map_ldm_unet,
                              map_ldm_vae, map_raydiff_dit, port_name)

    report: dict = {}
    mapped, unmapped = convert_tower(towers["traj"], map_trajdit_key,
                                     pipe.traj.model)
    report["traj"] = {"mapped": mapped, "unmapped": unmapped}

    # mvldm: model.unet.* / model.vae.* / model.text_encoder.*
    mv = pipe.mvldm.model
    mv_sd = towers["mvldm"]
    unet = mv.unet
    attn_levels = tuple(lv for lv in range(len(unet.channel_mult))
                        if 2 ** lv in unet.attention_ds)
    m1, miss1, un1 = apply_weight_map(
        _strip_prefix(mv_sd, "model.unet."),
        map_ldm_unet(len(unet.channel_mult), unet.num_res_blocks,
                     attention_levels=attn_levels), mv, prefix="unet/")
    m2, miss2, un2 = apply_weight_map(
        _strip_prefix(mv_sd, "model.vae."), map_ldm_vae(_vae_levels(mv.vae)),
        mv, prefix="vae/")
    m3, miss3, un3 = apply_weight_map(
        _strip_prefix(mv_sd, "model.text_encoder."),
        map_clip_text(mv.text_encoder.num_layers), mv, prefix="text_encoder/")
    mv_prefixes = ("model.unet.", "model.vae.", "model.text_encoder.")
    report["mvldm"] = {
        "mapped": m1 + m2 + m3,
        "missing": miss1 + miss2 + miss3,
        "unassigned": un1 + un2 + un3,
        "skipped": [k for k in mv_sd if not k.startswith(mv_prefixes)],
    }

    # decoder: model.vae.* (gaussian-headed, EMANorm-wrapped) and
    # model.cross_view_dit.*
    gs = pipe.gsdecoder
    buffers = dict(gs.named_buffers())
    gs_sd, ema_buffers = _normalize_gs_vae_sd(
        _strip_prefix(towers["decoder"], "model.vae."))
    m4, miss4, un4 = apply_weight_map(gs_sd, map_ldm_vae(_vae_levels(gs.vae)),
                                      gs, prefix="vae/")
    ema_unassigned = []
    for lvl, val in ema_buffers.items():
        path = f"vae/decoder/up_{lvl}_upsample/ema_norm/magnitude_ema"
        dst = buffers.get(port_name(path))
        if dst is None:
            ema_unassigned.append(path)
            continue
        if tuple(dst.shape) != tuple(val.shape):
            raise ValueError(f"shape mismatch at {path}: {tuple(dst.shape)} "
                             f"vs {tuple(val.shape)}")
        dst.copy_(val)
    m5, miss5, un5 = apply_weight_map(
        _strip_prefix(towers["decoder"], "model.cross_view_dit."),
        map_raydiff_dit(gs.dit_depth), gs,
        prefix="cross_view_dit/")
    gs_prefixes = ("model.vae.", "model.cross_view_dit.")
    report["decoder"] = {
        "mapped": m4 + m5 + (len(ema_buffers) - len(ema_unassigned)),
        "missing": miss4 + miss5,
        "unassigned": un4 + un5 + ema_unassigned,
        "skipped": [k for k in towers["decoder"]
                    if not k.startswith(gs_prefixes)],
    }
    return report


@torch.no_grad()
def reference_bundle(pipe) -> dict:
    """The inverse of ``convert_bundle``: ``pipe``'s three towers in the
    published ``full.ckpt`` layout, as ``split_full_ckpt`` returns it (CPU
    float32). The tables run backwards (``weight_maps.
    reference_state_dict``); the GS decoder's upsample convs are wrapped as
    the reference's EMANorm ``Sequential`` (``conv.0``) with their
    ``magnitude_ema`` as ``conv.1.magnitude_ema``; TrajDiT takes its
    reference names. The reference decoder's frozen ``model.decoder_2d.*``
    copy has no counterpart in the port and is not written."""
    from .weight_maps import (map_clip_text, map_ldm_unet, map_ldm_vae,
                              map_raydiff_dit, port_name,
                              reference_state_dict)

    mv, gs, traj = pipe.mvldm.model, pipe.gsdecoder, pipe.traj.model
    unet = mv.unet
    levels = tuple(lv for lv in range(len(unet.channel_mult))
                   if 2 ** lv in unet.attention_ds)
    mvldm = {}
    for prefix, pairs, dst in (
            ("model.unet.", map_ldm_unet(len(unet.channel_mult),
                                         unet.num_res_blocks, levels),
             "unet/"),
            ("model.vae.", map_ldm_vae(_vae_levels(mv.vae)), "vae/"),
            ("model.text_encoder.",
             map_clip_text(mv.text_encoder.num_layers), "text_encoder/")):
        mvldm.update({prefix + k: v for k, v in reference_state_dict(
            mv, pairs, dst).items()})
    decoder = {}
    for k, v in reference_state_dict(
            gs, map_ldm_vae(_vae_levels(gs.vae)), "vae/").items():
        m = re.fullmatch(r"decoder\.up\.(\d+)\.upsample\.conv\.(weight|bias)",
                         k)
        if m:
            k = f"decoder.up.{m.group(1)}.upsample.conv.0.{m.group(2)}"
        decoder["model.vae." + k] = v
    for name, buf in gs.named_buffers():
        m = re.fullmatch(r"vae\.decoder\.up_(\d+)_upsample\.ema_norm\."
                         r"magnitude_ema", name)
        if m:
            decoder[f"model.vae.decoder.up.{m.group(1)}.upsample.conv.1."
                    "magnitude_ema"] = buf.float().cpu().clone()
    decoder.update({"model.cross_view_dit." + k: v
                    for k, v in reference_state_dict(
                        gs, map_raydiff_dit(gs.dit_depth),
                        "cross_view_dit/").items()})
    own = dict(traj.named_parameters())
    depth = len({n.split(".")[0] for n in own if n.startswith("block_")})
    keys = list(TRAJ_KEYS) + [f"blocks.{i}.{k}" for i in range(depth)
                              for k in TRAJ_BLOCK_KEYS]
    trajs = {k: own[port_name(map_trajdit_key(k))].float().cpu().clone()
             for k in keys}
    return {"traj": trajs, "decoder": decoder, "mvldm": mvldm}


def pad_conv_in_channels(weight: np.ndarray, target_in: int,
                         rng: np.random.Generator,
                         copy_rgb_to_depth: bool = False,
                         std: float = 0.01) -> np.ndarray:
    """Widen a conv weight ``(O, I, kh, kw)`` to ``target_in`` input
    channels (the reference's conv surgery): the new channels get
    ``std``-normal values; optionally the first 4 (RGB-latent) input
    channels are copied into channels 4:8 (depth latents).

    ``rng`` is drawn in the JAX package's order, ``(kh, kw, new, O)``, so
    the result is JAX's ``pad_conv_in_channels`` of the flax kernel, in the
    torch layout, value for value."""
    o, i, kh, kw = weight.shape
    assert target_in >= i
    extra = rng.normal(0.0, std, size=(kh, kw, target_in - i, o)).astype(
        weight.dtype).transpose(3, 2, 0, 1)
    out = np.concatenate([weight, extra], axis=1)
    if copy_rgb_to_depth and target_in >= 8 and i >= 4:
        out[:, 4:8] = weight[:, 0:4]
    return out


def pad_conv_out_channels(weight: np.ndarray, bias: np.ndarray,
                          target_out: int, rng: np.random.Generator,
                          copy_rgb_to_depth: bool = False,
                          std: float = 0.01):
    """Widen a conv weight's output channels ``(O, I, kh, kw)`` and its
    bias likewise, drawing ``rng`` in JAX's order ``(kh, kw, I, new)``. The
    bias is zero-padded for every new channel: the depth rows get the RGB
    weights copied but keep a zero bias, as in the reference."""
    o, i, kh, kw = weight.shape
    extra = rng.normal(0.0, std, size=(kh, kw, i, target_out - o)).astype(
        weight.dtype).transpose(3, 2, 0, 1)
    w = np.concatenate([weight, extra], axis=0)
    b = np.concatenate([bias, np.zeros(target_out - o, bias.dtype)])
    if copy_rgb_to_depth and target_out >= 8 and o >= 4:
        w[4:8] = weight[0:4]
    return w, b


# ---------------------------------------------------------------------------
# The port's release bundle
# ---------------------------------------------------------------------------

BUNDLE_FILE = "bundle.pt"
TOWERS = ("mvldm", "gsdecoder", "traj")


def _tower_modules(pipe) -> dict:
    return {"mvldm": pipe.mvldm.model, "gsdecoder": pipe.gsdecoder,
            "traj": pipe.traj.model}


def write_bundle(out_dir: str, state_dicts: dict, widths: dict) -> str:
    """Write ``{tower: state dict}`` and ``{tower: constructor kwargs}`` as
    ``out_dir/bundle.pt`` (through a temporary name, so a cut write leaves
    no partial bundle); returns the file's path."""
    os.makedirs(out_dir, exist_ok=True)
    blob = {name: {k: v.detach().cpu() for k, v in state_dicts[name].items()}
            for name in TOWERS}
    blob["widths"] = {name: widths.get(name) for name in TOWERS}
    path = os.path.join(out_dir, BUNDLE_FILE)
    torch.save(blob, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def save_bundle(out_dir: str, pipe) -> str:
    """Write a pipeline's three tower state dicts, in their dtype, with the
    widths they were built with; returns the path of ``bundle.pt``."""
    modules = _tower_modules(pipe)
    return write_bundle(
        out_dir, {n: modules[n].state_dict() for n in TOWERS},
        {n: getattr(modules[n], "init_kwargs", None) for n in TOWERS})


def _read_bundle(path: str) -> dict:
    file = os.path.join(path, BUNDLE_FILE)
    if not os.path.isfile(file):
        raise FileNotFoundError(f"no {BUNDLE_FILE} in {path}")
    return torch.load(file, map_location="cpu", weights_only=True, mmap=True)


def bundle_tower(path: str, name: str) -> dict:
    """The state dict (CPU) of one tower of the bundle directory ``path``:
    ``mvldm``, ``gsdecoder`` or ``traj``."""
    return _read_bundle(path)[name]


def bundle_widths(path: str) -> dict:
    """The ``{tower: constructor kwargs}`` a bundle directory was built
    with (``inference.pipeline_from_args`` builds its pipeline from them,
    through ``pipeline.build_pipeline(widths=...)``)."""
    return _read_bundle(path)["widths"]


@torch.no_grad()
def load_bundle(path: str, pipe) -> None:
    """Load the bundle directory ``path`` into ``pipe``, cast to each
    module's dtype on its device. Strict: every tensor of every tower is
    checked before any is written, and a tensor that is missing, left over
    or of another shape raises ``ValueError`` naming the first one, so a
    bundle of other widths never loads in part."""
    raw = _read_bundle(path)
    modules = _tower_modules(pipe)
    for name in TOWERS:
        sd, own = raw[name], modules[name].state_dict()
        note = f"(bundle {path}, built with {raw['widths'].get(name)})"
        for k, v in own.items():
            if k not in sd:
                raise ValueError(f"{name}.{k} is not in the bundle {note}")
            if tuple(sd[k].shape) != tuple(v.shape):
                raise ValueError(
                    f"{name}.{k} has shape {tuple(sd[k].shape)} in the "
                    f"bundle and {tuple(v.shape)} in the pipeline {note}")
        extra = [k for k in sd if k not in own]
        if extra:
            raise ValueError(f"{name}.{extra[0]} of the bundle has no place "
                             f"in the pipeline {note}")
    for name in TOWERS:
        modules[name].load_state_dict(raw[name], strict=True)
