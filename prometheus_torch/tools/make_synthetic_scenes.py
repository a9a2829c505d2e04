"""Write a synthetic DL3DV-style scene corpus for from-disk training runs
(the counterpart of the repo's ``tools/make_synthetic_scenes.py``, same
arguments and files).

Scene directories of 720x960 JPEG frames plus an ``annotation.pkl`` in the
DL3DV layout (frames / poses / intrinsics / captions) that
``prometheus_torch.datasets`` reads. The frames are textured (smooth
gradients, sinusoids and noise), not constant, so the loader's JPEG decode
costs what a real frame's would. Usage::

    python -m prometheus_torch.tools.make_synthetic_scenes \
        --out data/scene_data --scenes 48 --frames 24
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
from PIL import Image


def scene_image(rng: np.random.Generator, h: int, w: int, phase: float,
                palette: np.ndarray) -> np.ndarray:
    """A cheap procedurally textured frame: view-dependent sinusoid field
    over a per-scene palette, plus broadband noise for JPEG realism."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                         np.linspace(0, 1, w, dtype=np.float32),
                         indexing="ij")
    base = (np.sin(2 * np.pi * (3 * xx + phase)) *
            np.cos(2 * np.pi * (2 * yy - 0.5 * phase)))
    img = palette[None, None, :, 0] + base[..., None] * palette[None, None, :, 1]
    img = img + rng.normal(0, 0.04, size=(h, w, 3)).astype(np.float32)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def orbit_poses(n: int, radius: float, rng: np.random.Generator) -> np.ndarray:
    """OpenGL look-at-origin c2ws (n, 3, 4) on a jittered arc."""
    import torch

    from ..utils.cameras import look_at

    az = np.linspace(0, np.pi, n) + rng.normal(0, 0.02, n)
    el = 0.2 + 0.1 * rng.normal(size=n)
    eye = np.stack([radius * np.cos(az), el, radius * np.sin(az)], -1)
    eye = torch.tensor(eye, dtype=torch.float32)
    return look_at(eye, torch.zeros(n, 3)).numpy()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--scenes", type=int, default=48)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out, exist_ok=True)
    ann = {}
    for s in range(args.scenes):
        scene = f"scene_{s:04d}"
        os.makedirs(os.path.join(args.out, scene), exist_ok=True)
        palette = rng.uniform(0.2, 0.8, size=(3, 2)).astype(np.float32)
        frames = []
        for i in range(args.frames):
            rel = f"{scene}/frame_{i:03d}.jpg"
            img = scene_image(rng, args.height, args.width,
                              phase=i / args.frames + s * 0.13, palette=palette)
            Image.fromarray(img).save(os.path.join(args.out, rel), quality=92)
            frames.append(rel)
        f_pix = 0.8 * args.width
        ann[scene] = {
            "frames": frames,
            "poses": orbit_poses(args.frames, 2.0 + 0.5 * rng.random(),
                                 rng).tolist(),
            "intrinsics": [f_pix, f_pix, args.width / 2, args.height / 2],
            "captions": [f"a synthetic textured scene {s}"],
        }
    with open(os.path.join(args.out, "annotation.pkl"), "wb") as fp:
        pickle.dump(ann, fp)
    n_img = args.scenes * args.frames
    print(f"wrote {args.scenes} scenes / {n_img} frames to {args.out}")


if __name__ == "__main__":
    main()
