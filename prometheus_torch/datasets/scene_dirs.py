"""Annotated multi-view scene datasets (``prometheus_tpu/datasets/
scene_dirs.py``): DL3DV, MVImgNet, UrbanGen and Objaverse.

All four read "an annotation lists scenes -> per-frame image files, poses
and intrinsics" and differ in pose convention and layout:

- ``DL3DV10KDataset``: a pkl annotation ``{scene: {frames: [...], poses
  (N, 3, 4) OpenGL, intrinsics, captions}}``, frames under the root;
- ``MVImgNetDataset``: the same with COLMAP (OpenCV) poses;
- ``UrbanGenDataset``: driving data with OpenCV poses and per-subdataset
  sample rates;
- ``ObjaverseDataset``: rendered views with OpenCV poses, random view
  sampling and CSV captions with a prompt prefix and suffix.

Without an annotation file the scenes come from ``<root>/<scene>/meta.json``.
"""
from __future__ import annotations

import csv
import json
import os

import numpy as np

from ..utils.cameras import opencv_to_opengl
from .base import MultiviewDataset, load_annotation
from .file_readers import make_reader
from .transforms import decode_crop_resize_normalize


class AnnotatedScenesDataset(MultiviewDataset):
    """An annotation dict ``{scene_name: meta}`` and a file reader."""

    pose_convention = "opengl"   # or "opencv"

    def __init__(self, root_dir: str, annotation_path: str | None = None,
                 dataset_name: str = "scenes", **kw):
        super().__init__(dataset_name=dataset_name, **kw)
        self.root_dir = root_dir
        self.reader = make_reader(root_dir)
        self.metadata = (load_annotation(annotation_path) if annotation_path
                         else self.build_metadata())
        self.items = sorted(self.metadata.keys())

    def build_metadata(self) -> dict:
        """Scan the ``<root>/<scene>/meta.json`` layout."""
        meta = {}
        if hasattr(self.reader, "list"):
            for name in self.reader.list():
                if name.endswith("meta.json"):
                    scene = os.path.dirname(name)
                    meta[scene] = json.loads(
                        self.reader.fetch(name).decode("utf-8"))
                    meta[scene].setdefault("scene_name", scene)
        return meta

    def inner_len(self) -> int:
        return len(self.items)

    def parse_scene(self, idx: int) -> dict:
        name = self.items[idx]
        meta = dict(self.metadata[name])
        meta.setdefault("scene_name", name)
        meta["num_frames"] = len(meta["frames"])
        return meta

    def _to_opengl(self, c2w: np.ndarray) -> np.ndarray:
        if self.pose_convention == "opencv":
            return opencv_to_opengl(c2w)
        return c2w

    def get_frames_data(self, scene: dict, frame_ids: np.ndarray, rng):
        images, c2ws, intrs = [], [], []
        poses = np.asarray(scene["poses"], np.float32)      # (N, 3, 4)
        intrinsics = np.asarray(scene["intrinsics"], np.float32)
        if intrinsics.ndim == 1:
            intrinsics = np.tile(intrinsics, (poses.shape[0], 1))
        for i in frame_ids:
            # annotation intrinsics are full-resolution pixels
            img, intr = decode_crop_resize_normalize(
                self.reader.fetch(scene["frames"][i]), self.img_size,
                intrinsics[i, :4])
            images.append(img)
            c2ws.append(self._to_opengl(poses[i]))
            intrs.append(intr)
        return np.stack(images), np.stack(c2ws), np.stack(intrs)


class DL3DV10KDataset(AnnotatedScenesDataset):
    pose_convention = "opengl"

    def __init__(self, root_dir: str, **kw):
        kw.setdefault("dataset_name", "DL3DV10K")
        super().__init__(root_dir, **kw)


class MVImgNetDataset(AnnotatedScenesDataset):
    pose_convention = "opencv"   # COLMAP-derived

    def __init__(self, root_dir: str, **kw):
        kw.setdefault("dataset_name", "MVImgNet")
        super().__init__(root_dir, **kw)


class UrbanGenDataset(AnnotatedScenesDataset):
    pose_convention = "opencv"

    def __init__(self, root_dir: str, sub_sample_rates: dict | None = None,
                 **kw):
        kw.setdefault("dataset_name", "UrbanGen")
        kw.setdefault("scene_scale_threshold", 1.0)
        super().__init__(root_dir, **kw)
        # per-subdataset (kitti360 / nuscenes / waymo) stride overrides
        self.sub_sample_rates = sub_sample_rates or {}

    def parse_scene(self, idx: int) -> dict:
        scene = super().parse_scene(idx)
        sub = scene.get("subdataset")
        if sub in self.sub_sample_rates:
            scene["sample_rate"] = self.sub_sample_rates[sub]
        return scene


class ObjaverseDataset(AnnotatedScenesDataset):
    pose_convention = "opencv"   # opencv_cameras.json

    def __init__(self, root_dir: str, caption_csv: str | None = None,
                 prompt_prefix: str = "", prompt_suffix: str = "3D asset.",
                 **kw):
        kw.setdefault("dataset_name", "Objaverse")
        kw.setdefault("view_type", "random")
        kw.setdefault("sample_rate", -1)
        kw.setdefault("normalized_cameras", False)
        self.prompt_prefix = prompt_prefix
        self.prompt_suffix = prompt_suffix
        self.captions: dict[str, str] = {}
        if caption_csv and os.path.exists(caption_csv):
            with open(caption_csv, newline="") as fp:
                for row in csv.reader(fp):
                    if len(row) >= 2:
                        self.captions[row[0]] = row[1]
        super().__init__(root_dir, **kw)

    def get_caption(self, scene: dict, rng) -> str:
        cap = self.captions.get(scene["scene_name"], "")
        if not cap:
            caps = scene.get("captions") or []
            cap = rng.choice(caps) if caps else ""
        if cap:
            return " ".join(filter(None, [self.prompt_prefix, cap,
                                          self.prompt_suffix]))
        return ""
