"""Data loader smoke run and picture (the counterpart of the repo's
``scripts/test_dataloader.py``, same arguments and files; upstream
``vis/test_dataloader.py``).

Iterates an annotated scene directory through the port's ``make_loader``
(4 worker processes), prints the batches' shapes and the rate, and writes
a grid of the first batch's images to ``--out/batch0.png``::

    python -m prometheus_torch.tools.test_dataloader --root SCENES \
        [--annotation SCENES/annotation.pkl] [--batch_size 4]
"""
from __future__ import annotations

import argparse
import os
import time


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=None, help="annotated-scenes root dir")
    ap.add_argument("--annotation", default=None)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--num_batches", type=int, default=5)
    ap.add_argument("--img_size", type=int, default=128)
    ap.add_argument("--out", default="/tmp/dataloader_smoke")
    args = ap.parse_args(argv)

    from ..datasets import DL3DV10KDataset, make_loader
    from ..utils.image import make_grid, postprocess_image, save_image

    if args.root is None:
        raise SystemExit("provide --root (see prometheus_torch.tools."
                         "build_metadata to create annotations)")
    ds = DL3DV10KDataset(args.root, annotation_path=args.annotation,
                         img_size=args.img_size, num_input_views=4,
                         num_novel_views=0)
    dl = make_loader(ds, args.batch_size, num_workers=4)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    for i, batch in enumerate(dl):
        if i >= args.num_batches:
            break
        print(f"batch {i}: images {batch['images_mv'].shape} "
              f"cameras {batch['cameras_mv'].shape} "
              f"texts {batch['text_mv'][:2]}")
        if i == 0:
            imgs = postprocess_image(batch["images_mv"].reshape(
                -1, 3, args.img_size, args.img_size).numpy())
            save_image(make_grid(imgs), os.path.join(args.out, "batch0.png"))
    n = min(args.num_batches, len(dl))
    dt = time.time() - t0
    print(f"{n} batches in {dt:.2f}s "
          f"({n * args.batch_size / dt:.1f} scenes/s)")
    return n * args.batch_size / dt


if __name__ == "__main__":
    main()
