"""Train-state checkpoints in a torch format (the counterpart of
``prometheus_tpu/checkpoint.py``'s Orbax save and resume-latest).

``save_checkpoint`` writes ``<ckpt_dir>/step_{step:09d}/state.pt`` holding
the step, the module's state dict (parameters and buffers, the EMANorm
magnitudes among them), the optimizer's state dict (a bf16 first moment
stays bf16) and the EMA, and keeps the newest ``keep`` checkpoints. A
checkpoint is written under a temporary name and renamed, so a cut run
never leaves a partial ``step_*`` directory.

``load_torch_state_dict`` reads a foreign torch checkpoint (a published
network's weights) into a flat dict of tensors.
"""
from __future__ import annotations

import os
import re
import shutil

import torch

from .parallel import full_ema_params

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


def save_checkpoint(ckpt_dir: str, state, step: int, keep: int = 3) -> str:
    """Write ``state`` (a ``TrainState``) as ``step_{step:09d}``; returns
    its path."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"step": state.step, "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "ema": state.ema_params}, os.path.join(tmp, STATE_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    if keep > 0:
        for s in list_checkpoints(ckpt_dir)[:-keep]:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                          ignore_errors=True)
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
    state.optimizer.load_state_dict(raw["optimizer"])
    with torch.no_grad():
        for name, value in raw["ema"].items():
            state.ema_params[name].copy_(value)
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
