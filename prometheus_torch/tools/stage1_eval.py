"""Stage-1 (GS decoder) novel-view reconstruction evaluation (the
counterpart of the repo's ``tools/stage1_eval.py``, same arguments and
files; upstream ``paper/stage1_eval.py``).

Runs ``GSDecoderSystem.inference`` on RE10K-format scenes (an
mvsplat-style evaluation index picks each scene's context and target
frames), with the context views' disparity from a DA2-Small teacher
(seeded random weights, as in the JAX tool), renders the target views and
writes pred / gt / error / depth frames and ``metrics.json`` (PSNR and SSIM
of ``metrics.py``, each scene's and their means)::

    python -m prometheus_torch.tools.stage1_eval --data_root data/re10k/test \\
        --eval_index assets/evaluation_index_re10k.json \\
        --ckpt workdir/gsdecoder_ckpts --out eval_stage1/ [--small]

``--ckpt`` reads the port's own checkpoints (a ``step_*`` directory, or a
directory of them whose newest is taken; the EMA weights are laid over)
and release bundles (a directory with ``bundle.pt``: its ``gsdecoder``
tower); the decoder is built at the widths they record. The JAX package's
orbax directories are not read. The decoder runs in float32, as the JAX
tool's does.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

# the JAX tool's --small widths of the GS decoder
SMALL_WIDTHS = dict(dit_hidden_size=64, dit_depth=2, dit_num_heads=4,
                    vae_ch=32, vae_ch_mult=(1, 2, 4))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--eval_index", required=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--out", default="./eval_stage1")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--max_scenes", type=int, default=-1)
    ap.add_argument("--render_size", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build_system(small: bool, render_size: int, device,
                 ckpt: str | None = None, seed: int = 0):
    """The float32 ``GSDecoderSystem`` at the ``--small`` or flagship widths
    (or those ``ckpt`` records) with seeded random weights, then ``ckpt``'s
    weights when given."""
    from ..checkpoint import (BUNDLE_FILE, bundle_tower, bundle_widths,
                              latest_checkpoint, load_ema_weights_,
                              restore_checkpoint)
    from ..models import GSDecoderModel
    from ..systems import GSDecoderSystem
    from ..weights import random_module

    widths = dict(SMALL_WIDTHS) if small else {}
    state, path = None, None
    if ckpt and os.path.isfile(os.path.join(ckpt, BUNDLE_FILE)):
        widths = bundle_widths(ckpt).get("gsdecoder") or widths
        state = bundle_tower(ckpt, "gsdecoder")
        path = ckpt
    elif ckpt:
        path = latest_checkpoint(ckpt) or ckpt
        widths = restore_checkpoint(path).get("widths") or widths
    g = torch.Generator(device=device).manual_seed(seed)
    model = random_module(GSDecoderModel, widths, device, g)
    if state is not None:
        model.load_state_dict({k: v.float() for k, v in state.items()})
    elif path is not None:
        load_ema_weights_(model, path)
    if path is not None:
        print(f"[stage1_eval] loaded {path}")
    return GSDecoderSystem(model=model.float().eval(),
                           render_size=render_size)


@torch.no_grad()
def evaluate_scene(system, depth_fn, item: dict, out_dir: str,
                   render_size: int, noise: torch.Tensor | None = None):
    """One scene of ``RealEstate10KDatasetEval``: the context views'
    disparity from ``depth_fn``, the decoder's renders of the target views,
    their PSNR and SSIM against the targets (in [0, 1]) and the pred / gt /
    error / depth PNGs under ``out_dir/<scene>/``. ``noise`` is the encoder's
    draw (None: the posterior's mode). Returns ``(entry, outputs)``: the
    scene's ``{"scene", "psnr", "ssim"}`` and ``inference``'s dict."""
    from ..metrics import psnr, ssim
    from ..utils.image import colorize_depth, postprocess_image, save_image

    device = system.model.vae.post_quant_conv.weight.device
    nc = item["num_context"]
    images = torch.as_tensor(item["images_mv"])[None].to(device)
    cams = torch.as_tensor(item["cameras_mv"])[None].to(device)
    disp = depth_fn(images[:, :nc])
    out = system.inference(images[:, :nc], disp, cams[:, :nc], cams[:, nc:],
                           noise=noise, render_size=render_size)
    pred = out["images_nv_pred"][0].float().cpu().numpy()
    depth = out["depths_nv_pred"][0].float().cpu().numpy()
    gt = np.asarray(item["images_mv"][nc:])
    scene_dir = os.path.join(out_dir, item["scene_name_mv"])
    os.makedirs(scene_dir, exist_ok=True)
    scene_psnr, scene_ssim = [], []
    for v in range(pred.shape[0]):
        p01 = (pred[v].transpose(1, 2, 0) + 1) / 2
        g01 = (gt[v].transpose(1, 2, 0) + 1) / 2
        scene_psnr.append(psnr(p01, g01))
        scene_ssim.append(ssim(p01, g01))
        save_image(postprocess_image(pred[v]),
                   os.path.join(scene_dir, f"pred_{v:02d}.png"))
        save_image(postprocess_image(gt[v]),
                   os.path.join(scene_dir, f"gt_{v:02d}.png"))
        err = np.abs(p01 - g01).mean(-1)
        save_image(colorize_depth(err, 0, 0.5),
                   os.path.join(scene_dir, f"error_{v:02d}.png"))
        save_image(colorize_depth(depth[v, 0]),
                   os.path.join(scene_dir, f"depth_{v:02d}.png"))
    entry = {"scene": item["scene_name_mv"],
             "psnr": float(np.mean(scene_psnr)),
             "ssim": float(np.mean(scene_ssim))}
    return entry, out


def main(argv=None) -> dict:
    args = parse_args(argv)
    from ..datasets import RealEstate10KDatasetEval
    from ..models.depth_anything import make_depth_fn
    from ..utils import resolve_device

    device = resolve_device(args.device)
    system = build_system(args.small, args.render_size, device, args.ckpt)
    depth_fn = make_depth_fn(device=device)
    ds = RealEstate10KDatasetEval(
        args.data_root, args.eval_index, img_size=args.render_size,
        scene_scale_threshold=0.0)
    os.makedirs(args.out, exist_ok=True)

    results = []
    n = len(ds) if args.max_scenes <= 0 else min(args.max_scenes, len(ds))
    for i in range(n):
        entry, _ = evaluate_scene(system, depth_fn, ds[i], args.out,
                                  args.render_size)
        results.append(entry)
        print(f"[{i+1}/{n}] {entry['scene']}: "
              f"psnr {entry['psnr']:.2f} ssim {entry['ssim']:.3f}")

    summary = {"psnr_mean": float(np.mean([r["psnr"] for r in results])),
               "ssim_mean": float(np.mean([r["ssim"] for r in results])),
               "num_scenes": len(results), "per_scene": results}
    with open(os.path.join(args.out, "metrics.json"), "w") as fp:
        json.dump(summary, fp, indent=2)
    print(json.dumps({k: v for k, v in summary.items() if k != "per_scene"}))
    return summary


if __name__ == "__main__":
    main()
