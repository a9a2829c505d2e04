"""Throughput of the host data plane (the counterpart of the repo's
``tools/bench_loader.py``, same arguments; its JSON line adds the
thread-pool rates).

Times the training input pipeline end to end (JPEG decode, the fused crop /
antialiased resize / normalisation, camera processing, collation) through
the port's ``make_loader`` (worker processes) over a synthetic DL3DV-style
corpus on disk, and the same items through as many threads of one process
(the JAX loader's design), for the native data plane
(``prometheus_torch.native``) and the PIL + numpy path
(``PROMETHEUS_NATIVE=0``)::

    python -m prometheus_torch.tools.bench_loader [--scenes 8] \
        [--frames 24] [--hw 720 960] [--img_size 256] [--views 8] \
        [--batch 4] [--workers 4] [--seconds 20]

Prints one JSON line: images/s for each path, the median of ``--repeats``
timed runs, with worker processes (``images_per_s_<path>``) and with
threads (``images_per_s_<path>_threads``).
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np


def build_dataset(root: str, scenes: int, frames: int, hw, rng) -> str:
    from PIL import Image

    ann = {}
    for s in range(scenes):
        name = f"scene_{s}"
        os.makedirs(os.path.join(root, name), exist_ok=True)
        flist = []
        # structured content so JPEG size is realistic (noise inflates it)
        yy, xx = np.mgrid[0 : hw[0], 0 : hw[1]]
        for i in range(frames):
            arr = (127 + 80 * np.sin(yy / (7 + s) + i)
                   + 60 * np.cos(xx / (11 + i))
                   + rng.normal(0, 8, hw)).clip(0, 255)
            img = np.stack([arr, np.roll(arr, 7, 0), np.roll(arr, 3, 1)],
                           -1).astype(np.uint8)
            f = f"{name}/frame_{i:03d}.jpg"
            Image.fromarray(img).save(os.path.join(root, f), quality=90)
            flist.append(f)
        az = np.linspace(0, np.pi, frames)
        eye = np.stack([2.0 * np.cos(az), 0.2 * np.ones(frames),
                        2.0 * np.sin(az)], -1)
        # numpy OpenGL look-at-origin
        fwd = -eye / np.linalg.norm(eye, axis=-1, keepdims=True)
        up = np.asarray([0.0, 1.0, 0.0])[None]
        right = np.cross(fwd, np.broadcast_to(up, fwd.shape))
        right /= np.linalg.norm(right, axis=-1, keepdims=True)
        true_up = np.cross(right, fwd)
        poses = np.stack([right, true_up, -fwd, eye], -1)  # (N, 3, 4)
        ann[name] = {
            "frames": flist,
            "poses": poses.tolist(),
            "intrinsics": [hw[1] * 0.8, hw[1] * 0.8, hw[1] / 2, hw[0] / 2],
            "captions": [f"synthetic scene {s}"],
        }
    ann_path = os.path.join(root, "annotation.pkl")
    with open(ann_path, "wb") as fp:
        pickle.dump(ann, fp)
    return ann_path


def run_epochs(loader, views: int, seconds: float) -> float:
    """Iterate until the deadline; returns images/second. Each pass over
    the loader is a new epoch (its batch sampler counts them)."""
    t0 = time.perf_counter()
    n_imgs = 0
    while time.perf_counter() - t0 < seconds:
        for batch in loader:
            n_imgs += batch["images_mv"].shape[0] * views
            if time.perf_counter() - t0 >= seconds:
                break
    return n_imgs / (time.perf_counter() - t0)


def run_threads(ds, workers: int, batch: int, views: int,
                seconds: float) -> float:
    """The same items through ``workers`` threads of this process (the
    JAX loader's design), a batch at a time, until the deadline; returns
    images/second."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    n_imgs, start = 0, 0
    with ThreadPoolExecutor(workers) as pool:
        while time.perf_counter() - t0 < seconds:
            items = list(pool.map(ds.__getitem__,
                                  range(start, start + batch)))
            n_imgs += len(items) * views
            start += batch
    return n_imgs / (time.perf_counter() - t0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenes", type=int, default=8)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--hw", type=int, nargs=2, default=(720, 960))
    ap.add_argument("--img_size", type=int, default=256)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed repeats per path; the MEDIAN is reported "
                         "(host-load variance made single-shot numbers "
                         "irreproducible across runs)")
    ap.add_argument("--root", type=str, default=None,
                    help="reuse an existing synthetic dataset dir")
    args = ap.parse_args(argv)

    import tempfile

    from .. import native
    from ..datasets import make_loader as loader_of
    from ..datasets.scene_dirs import DL3DV10KDataset

    tmp = None
    root = args.root
    if root is None:
        tmp = tempfile.TemporaryDirectory(prefix="bench_loader_")
        root = tmp.name
        build_dataset(root, args.scenes, args.frames, tuple(args.hw),
                      np.random.default_rng(0))

    def dataset():
        return DL3DV10KDataset(
            root, annotation_path=os.path.join(root, "annotation.pkl"),
            img_size=args.img_size, num_input_views=args.views,
            num_novel_views=0, fake_length=100000,
            scene_scale_threshold=0.0)

    def make_loader():
        return loader_of(dataset(), args.batch, num_workers=args.workers,
                         seed=0)

    repeats = max(1, args.repeats)
    each = args.seconds / repeats
    results = {}
    before = os.environ.get("PROMETHEUS_NATIVE")
    for label, env in (("native", "1"), ("python", "0")):
        # the loader hands the switch to its workers when it is made
        os.environ["PROMETHEUS_NATIVE"] = env
        # warm-up (the library's build, the file cache, the workers' start)
        run_epochs(make_loader(), args.views, min(3.0, args.seconds / 4))
        reps = sorted(run_epochs(make_loader(), args.views, each)
                      for _ in range(repeats))
        thr = sorted(run_threads(dataset(), args.workers, args.batch,
                                 args.views, each) for _ in range(repeats))
        results[f"images_per_s_{label}"] = reps[len(reps) // 2]
        results[f"images_per_s_{label}_runs"] = reps
        results[f"images_per_s_{label}_threads"] = thr[len(thr) // 2]
        results[f"images_per_s_{label}_threads_runs"] = thr
    if before is None:
        os.environ.pop("PROMETHEUS_NATIVE", None)
    else:
        os.environ["PROMETHEUS_NATIVE"] = before
    results["jpeg_native"] = native.jpeg_available()
    results["native_speedup"] = (results["images_per_s_native"]
                                 / results["images_per_s_python"])
    results.update(scenes=args.scenes, frames=args.frames,
                   src_hw=list(args.hw), img_size=args.img_size,
                   views=args.views, batch=args.batch, workers=args.workers)
    print(json.dumps(results))
    if tmp is not None:
        tmp.cleanup()
    return results


if __name__ == "__main__":
    main()
