"""Write teacher inverse-depth annotations with Depth-Anything-V2 (the
counterpart of the repo's ``tools/generate_depths.py``, same arguments and
files; upstream ``tools/dl3dv10k/get_depth.py``).

Walks a dataset annotation, runs the DA2-Small teacher
(``models/depth_anything.py::make_depth_fn``, float32, on the card unless
``--device cpu``) on every frame in batches of ``--batch``, and saves each
frame's inverse depth, normalised to [0, 1], for stage-1 training::

    python -m prometheus_torch.tools.generate_depths --root data/dl3dv \\
        --annotation data/dl3dv/annotation.pkl --out data/dl3dv_depth \\
        --weights depth_anything_v2_small.pt [--size 518]

``--weights`` is a transformers ``DepthAnythingForDepthEstimation`` state
dict, read by the port's HF loader. Without it a luminance proxy runs (a
loud warning; smoke runs only). Writes ``<out>/<frame>.npy`` (float16
inverse depth in [0, 1]) mirroring the frame paths, and
``<annotation>.depth.pkl`` with each scene's ``depths`` list.
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True, help="frame root dir")
    ap.add_argument("--annotation", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--weights", default=None,
                    help="torch DepthAnything-V2 checkpoint (transformers "
                         "format); luminance proxy if absent")
    ap.add_argument("--size", type=int, default=518,
                    help="inference resolution (DA-v2 patch-multiple)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max_scenes", type=int, default=-1)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def luminance_depth(images: torch.Tensor) -> torch.Tensor:
    """The smoke-run proxy: the mean of the channels, mapped to [0, 1]."""
    lum = images.mean(dim=2, keepdim=True) * 0.5 + 0.5
    return torch.clamp(lum, 0.0, 1.0)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from ..datasets.transforms import (center_crop_and_resize, decode_image,
                                       normalize_image)
    from ..utils import resolve_device

    device = resolve_device(args.device)
    if args.weights:
        from ..models.depth_anything import make_depth_fn

        depth_fn = make_depth_fn(args.weights, device=device)
    else:
        print("[depths] WARNING: no --weights -> luminance proxy teacher "
              "(smoke only; converted DA-v2 weights for real annotations)")
        depth_fn = luminance_depth

    with open(args.annotation, "rb") as fp:
        ann = pickle.load(fp)

    n_frames = 0
    for si, (scene, meta) in enumerate(sorted(ann.items())):
        if args.max_scenes > 0 and si >= args.max_scenes:
            break
        depths = []
        frames = meta["frames"]
        for i in range(0, len(frames), args.batch):
            chunk = frames[i:i + args.batch]
            imgs = []
            for f in chunk:
                with open(os.path.join(args.root, f), "rb") as fp:
                    raw = decode_image(fp.read())
                img, _ = center_crop_and_resize(raw, args.size)
                imgs.append(normalize_image(img))
            x = torch.from_numpy(np.stack(imgs)).to(device)
            with torch.no_grad():
                disp = depth_fn(x[None])[0].float().cpu().numpy()
            # each frame normalised to [0, 1] inverse depth (the upstream
            # get_depth.py stores normalised relative inverse depth)
            lo = disp.min(axis=(1, 2, 3), keepdims=True)
            hi = disp.max(axis=(1, 2, 3), keepdims=True)
            disp = (disp - lo) / np.maximum(hi - lo, 1e-6)
            for f, d in zip(chunk, disp):
                rel = os.path.splitext(f)[0] + ".npy"
                path = os.path.join(args.out, rel)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                np.save(path, d[0].astype(np.float16))
                depths.append(rel)
                n_frames += 1
        meta["depths"] = depths
    out_ann = args.annotation + ".depth.pkl"
    with open(out_ann, "wb") as fp:
        pickle.dump(ann, fp)
    print(f"[depths] {n_frames} frames -> {args.out}; annotation {out_ann}")
    return {"frames": n_frames, "annotation": out_ann}


if __name__ == "__main__":
    main()
