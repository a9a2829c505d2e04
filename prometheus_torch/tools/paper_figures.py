"""Paper-figure composition and LSUN-style data preparation (the
counterpart of the repo's ``tools/paper_figures.py``, same subcommands,
arguments and files; numpy and PIL only).

- ``figure``: a colour-coded multi-row panel of an inference or eval export
  directory (inputs / renders / depths, a row each), the upstream
  ``paper/method_stage1.py`` / ``method_stage2.py``;
- ``teaser``: a prompt x view grid over a generated gallery, the upstream
  ``paper/teaser.py``;
- ``convert``: recursive webp -> jpg conversion, the upstream
  ``paper/prepare_lsun.py``.

::

    python -m prometheus_torch.tools.paper_figures figure \
        --scene_dir out/scene0 --out fig.png
    python -m prometheus_torch.tools.paper_figures teaser \
        --gallery_dir gallery --out teaser.png
    python -m prometheus_torch.tools.paper_figures convert \
        --src lsun_webp --dst lsun_jpg
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils.image import ImageGrid, colorize_depth, load_image

# matplotlib 'Spectral' endpoints sampled at 8 stops — the reference's
# view_color_coded_images borders each view by its position in the sweep
_SPECTRAL = np.asarray([
    (158, 1, 66), (213, 62, 79), (244, 109, 67), (253, 174, 97),
    (254, 224, 139), (230, 245, 152), (171, 221, 164), (102, 194, 165),
], np.uint8)


def _color_border(img: np.ndarray, frac: float, width: int = 3) -> np.ndarray:
    """Frame a view with its Spectral sweep color (position ``frac`` in
    [0, 1]) — the reference's color-coding for camera order."""
    c = _SPECTRAL[min(int(frac * (len(_SPECTRAL) - 1) + 0.5),
                      len(_SPECTRAL) - 1)]
    out = img.copy()
    out[:width], out[-width:] = c, c
    out[:, :width], out[:, -width:] = c, c
    return out


def _load_views(d: str, exts=(".png", ".jpg", ".jpeg")) -> list[np.ndarray]:
    files = sorted(f for f in os.listdir(d)
                   if os.path.splitext(f)[1].lower() in exts)
    return [load_image(os.path.join(d, f)) for f in files]


def compose_stage_figure(scene_dir: str, out: str, spacing: int = 4) -> str:
    """Method-stage panel from an inference/eval export dir: one row per
    available subdir among ``inputs`` / ``renders`` (or ``image``) /
    ``depth``, views color-coded by camera order."""
    rows = []
    for name in ("inputs", "renders", "image", "images"):
        p = os.path.join(scene_dir, name)
        if os.path.isdir(p):
            rows.append(_load_views(p))
    depth_dir = os.path.join(scene_dir, "depth")
    if os.path.isdir(depth_dir):
        deps = []
        for f in sorted(os.listdir(depth_dir)):
            fp = os.path.join(depth_dir, f)
            if f.endswith(".npy"):
                deps.append(colorize_depth(np.load(fp)))
            elif os.path.splitext(f)[1].lower() in (".png", ".jpg"):
                deps.append(load_image(fp))
        if deps:
            rows.append(deps)
    if not rows:
        raise SystemExit(f"no inputs/renders/depth subdirs under {scene_dir}")
    n = max(len(r) for r in rows)
    grid = ImageGrid(len(rows), n, spacing=spacing)
    for i, row in enumerate(rows):
        for j, img in enumerate(row):
            grid.add(i, j, _color_border(np.asarray(img, np.uint8),
                                         j / max(n - 1, 1)))
    grid.save(out)
    return out


def compose_teaser(gallery_dir: str, out: str, max_prompts: int = 6,
                   views_per_prompt: int = 4, spacing: int = 4) -> str:
    """Teaser grid over a generated gallery (one subdir per prompt of view
    PNGs, the layout ``eval.py`` / ``inference.py`` export)."""
    prompts = sorted(
        d for d in os.listdir(gallery_dir)
        if os.path.isdir(os.path.join(gallery_dir, d)))[:max_prompts]
    if not prompts:
        raise SystemExit(f"no prompt dirs under {gallery_dir}")
    grid = ImageGrid(len(prompts), views_per_prompt, spacing=spacing)
    for i, prompt in enumerate(prompts):
        views = _load_views(os.path.join(gallery_dir, prompt))
        # an even sweep through the available views
        take = np.linspace(0, len(views) - 1,
                           min(views_per_prompt, len(views))).astype(int)
        for j, v in enumerate(take):
            grid.add(i, j, views[v])
    grid.save(out)
    return out


def convert_webp(src: str, dst: str) -> int:
    """Recursive webp -> RGB jpg conversion (``prepare_lsun.py`` analog)."""
    from PIL import Image

    os.makedirs(dst, exist_ok=True)
    n = 0
    for root, _, files in os.walk(src):
        for f in files:
            if f.lower().endswith(".webp"):
                with Image.open(os.path.join(root, f)) as im:
                    im.convert("RGB").save(
                        os.path.join(dst, os.path.splitext(f)[0] + ".jpg"),
                        "JPEG")
                n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    f = sub.add_parser("figure", help="method-stage comparison panel")
    f.add_argument("--scene_dir", required=True)
    f.add_argument("--out", required=True)
    t = sub.add_parser("teaser", help="prompt x view gallery grid")
    t.add_argument("--gallery_dir", required=True)
    t.add_argument("--out", required=True)
    t.add_argument("--max_prompts", type=int, default=6)
    t.add_argument("--views_per_prompt", type=int, default=4)
    c = sub.add_parser("convert", help="recursive webp -> jpg")
    c.add_argument("--src", required=True)
    c.add_argument("--dst", required=True)
    args = ap.parse_args(argv)
    if args.cmd == "figure":
        print(compose_stage_figure(args.scene_dir, args.out))
    elif args.cmd == "teaser":
        print(compose_teaser(args.gallery_dir, args.out,
                             args.max_prompts, args.views_per_prompt))
    else:
        print(f"converted {convert_webp(args.src, args.dst)} images")


if __name__ == "__main__":
    main()
