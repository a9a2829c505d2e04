"""Dataset text / trajectory gallery: browse what the data pipeline feeds
(the counterpart of the repo's ``tools/dataset_gallery.py``, same
arguments and files).

Samples K scenes from a configured dataset tree (the config-group
composition ``prometheus_torch.train`` uses) or from an annotated scene
directory, and writes one HTML gallery with, for each scene, its caption,
its sampled frames as an image strip and a top-down frustum plot of its
camera trajectory. It runs on the host (numpy and PIL)::

    python -m prometheus_torch.tools.dataset_gallery --root SCENES \
        [--num_scenes 8]
    python -m prometheus_torch.tools.dataset_gallery \
        --config prometheus_torch/configs/config.yaml [--split train] \
        [--num_scenes 8] [--out /tmp/ds_gallery]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils.image import make_grid, postprocess_image, save_image
from ..utils.visualization import plot_cameras_png, write_html_gallery


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=None, help="annotated-scenes root dir")
    ap.add_argument("--annotation", default=None)
    ap.add_argument("--config", default=None,
                    help="composed config (dataset group) instead of --root")
    ap.add_argument("--split", default="train", choices=["train", "val"])
    ap.add_argument("--num_scenes", type=int, default=8)
    ap.add_argument("--img_size", type=int, default=128)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--out", default="/tmp/ds_gallery")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.config:
        from ..config import load_config
        from ..datasets.builder import build_dataset, common_kwargs_from_group

        cfg = load_config(args.config)
        group = cfg.dataset
        node = group[args.split]
        common = common_kwargs_from_group(group)
        common.setdefault("img_size", args.img_size)
        ds = build_dataset(node, common)
    elif args.root:
        from ..datasets import DL3DV10KDataset

        ds = DL3DV10KDataset(
            args.root, annotation_path=args.annotation,
            img_size=args.img_size, num_input_views=args.views,
            num_novel_views=0)
    else:
        raise SystemExit("provide --root or --config")

    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    n = min(args.num_scenes, len(ds))
    idxs = rng.choice(len(ds), size=n, replace=False)

    entries = []
    for k, idx in enumerate(idxs):
        item = ds[int(idx)]
        if "images_mv" not in item:       # e.g. pure-T2I leaf of a mixer
            imgs = item.get("images_sv")
            caption = (item.get("text_sv") or ["(no caption)"])[0]
            cams = None
            scene = f"t2i_{idx}"
        else:
            imgs = item["images_mv"]
            caption = item.get("text_mv", "(no caption)")
            if isinstance(caption, (list, tuple)):
                caption = caption[0]
            cams = np.asarray(item["cameras_mv"])
            scene = str(item.get("scene_name_mv", idx))
        files = []
        if imgs is not None:
            frames = postprocess_image(np.asarray(imgs))
            strip = os.path.join(args.out, f"{k:03d}_frames.png")
            save_image(make_grid(frames, cols=len(frames)), strip)
            files.append(os.path.basename(strip))
        if cams is not None:
            traj = os.path.join(args.out, f"{k:03d}_traj.png")
            plot_cameras_png(traj, cams)
            files.append(os.path.basename(traj))
        name = item.get("dataset_name_mv", type(ds).__name__)
        entries.append({"title": f"[{name}] {scene}: {caption}",
                        "images": files})
        print(f"[{k+1}/{n}] {scene}: {caption[:70]}")

    html = write_html_gallery(os.path.join(args.out, "index.html"), entries,
                              title="dataset text/trajectory gallery")
    print(f"gallery: {html}")
    return html


if __name__ == "__main__":
    main()
