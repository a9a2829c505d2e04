"""Bundle the port's trained stage checkpoints into one release bundle (the
counterpart of the repo's ``tools/create_final_ckpt.py``).

Reads each stage's newest ``step_*`` checkpoint (``prometheus_torch.train``'s
``--ckpt_dir``), lays its EMA over the parameters the EMA tracks
(``parallel.full_ema_params``; ``--no_ema`` keeps the trained weights), drops
the optimizer state and writes ``OUT/bundle.pt`` (``checkpoint.
write_bundle``), which ``python -m prometheus_torch.inference --ckpt OUT``
loads::

    python -m prometheus_torch.tools.create_final_ckpt \\
        --mvldm workdir/mvldm_ckpts --gsdecoder workdir/gsdecoder_ckpts \\
        --traj workdir/trajdit_ckpts --out pretrained/bundle [--no_ema]

The tensors keep the checkpoints' dtype (float32 for the trainers' master
weights); loading casts them to the pipeline's.
"""
from __future__ import annotations

import argparse

import torch

from ..checkpoint import latest_checkpoint, restore_checkpoint, write_bundle
from ..models import GSDecoderModel, MVLDMModel, TrajDiTModel
from ..parallel import full_ema_params

STAGE_MODELS = {"mvldm": MVLDMModel, "gsdecoder": GSDecoderModel,
                "traj": TrajDiTModel}


def load_stage(name: str, ckpt_dir: str,
               use_ema: bool = True) -> tuple[dict, dict, str]:
    """The newest checkpoint of stage ``name`` under ``ckpt_dir`` ->
    ``(state dict with the EMA laid over its parameters, widths, path)``.
    The state dict is checked against the model its widths build."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    raw = restore_checkpoint(path)
    widths = raw.get("widths")
    if widths is None:
        raise ValueError(f"{path} records no widths (``init_kwargs``) to "
                         "build its model with")
    with torch.device("meta"):
        model = STAGE_MODELS[name](**widths)
    model.load_state_dict(raw["model"], assign=True)
    sd = model.state_dict()
    if use_ema:
        sd.update(full_ema_params(model, raw["ema"]))
    return sd, widths, path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Bundle the port's stage checkpoints into a release "
                    "bundle")
    ap.add_argument("--mvldm", required=True)
    ap.add_argument("--gsdecoder", required=True)
    ap.add_argument("--traj", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--no_ema", action="store_true")
    args = ap.parse_args(argv)

    state_dicts, widths = {}, {}
    for name in ("mvldm", "gsdecoder", "traj"):
        state_dicts[name], widths[name], src = load_stage(
            name, getattr(args, name), use_ema=not args.no_ema)
        print(f"[bundle] {name}: {src}")
    write_bundle(args.out, state_dicts, widths)
    print(f"[bundle] wrote {args.out}")


if __name__ == "__main__":
    main()
