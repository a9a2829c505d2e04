"""RealEstate10K / ACID (``prometheus_tpu/datasets/re10k.py``): pixelSplat
``.torch`` chunk files.

``root/index.json`` maps a scene key to its chunk; a chunk is a
``torch.save``d list of ``{key, images: [JPEG-bytes uint8 tensors],
cameras: (N, 18)}`` whose camera rows are ``[fx, fy, cx, cy, _, _,
w2c.flatten(12)]`` with the intrinsics divided by the image size and the
world-to-camera pose in OpenCV convention. ``RealEstate10KDatasetEval``
takes explicit context / target frame ids from an evaluation index.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..utils.cameras import opencv_to_opengl
from .base import MultiviewDataset
from .transforms import decode_crop_resize_normalize


def _load_chunk(path: str) -> list:
    chunk = torch.load(path, map_location="cpu", weights_only=True)
    return [chunk] if isinstance(chunk, dict) else chunk


class RealEstate10KDataset(MultiviewDataset):
    def __init__(self, root_dir: str, dataset_name: str = "RealEstate10K",
                 annotation_path: str | None = None, **kw):
        kw.setdefault("img_size", 256)
        super().__init__(dataset_name=dataset_name, **kw)
        self.root_dir = root_dir
        with open(annotation_path or os.path.join(root_dir,
                                                  "index.json")) as fp:
            self.index: dict[str, str] = json.load(fp)
        self.items = sorted(self.index.keys())
        self._chunk_cache: dict[str, list] = {}

    def inner_len(self) -> int:
        return len(self.items)

    def _load_scene(self, key: str) -> dict:
        path = self.index[key]
        if path not in self._chunk_cache:
            # keep the last chunk only (a chunk holds many scenes)
            self._chunk_cache.clear()
            self._chunk_cache[path] = _load_chunk(
                os.path.join(self.root_dir, path))
        for entry in self._chunk_cache[path]:
            if entry["key"] == key:
                return entry
        raise KeyError(f"scene {key} not found in chunk {path}")

    def parse_scene(self, idx: int) -> dict:
        key = self.items[idx]
        data = self._load_scene(key)
        return {"scene_name": key, "num_frames": len(data["images"]),
                "raw": data, "captions": []}

    def get_frames_data(self, scene: dict, frame_ids: np.ndarray, rng):
        data = scene["raw"]
        images, c2ws, intrs = [], [], []
        for i in frame_ids:
            cam = np.asarray(data["cameras"][i], np.float32)
            # cam[:4] = [fx/W, fy/H, cx/W, cy/H], resolved against the
            # decoded size
            img, intr = decode_crop_resize_normalize(
                bytes(np.asarray(data["images"][i]).tobytes()),
                self.img_size, cam[:4], normalized=True)
            w2c = np.eye(4, dtype=np.float64)
            w2c[:3] = cam[6:18].reshape(3, 4)
            c2ws.append(opencv_to_opengl(np.linalg.inv(w2c)[:3]))
            images.append(img)
            intrs.append(intr)
        return (np.stack(images), np.stack(c2ws).astype(np.float32),
                np.stack(intrs))


class RealEstate10KDatasetEval(RealEstate10KDataset):
    """Explicit context / target frame ids (an mvsplat-style evaluation
    index json)."""

    def __init__(self, root_dir: str, eval_index_path: str, **kw):
        super().__init__(root_dir, **kw)
        with open(eval_index_path) as fp:
            self.eval_index = json.load(fp)
        self.items = [k for k in self.items if k in self.eval_index
                      and self.eval_index[k] is not None]

    def sample_views(self, num_frames: int, rng) -> np.ndarray:
        raise NotImplementedError("the eval dataset uses explicit indices")

    def get_raw_data(self, idx: int, rng):
        scene = self.parse_scene(idx)
        entry = self.eval_index[scene["scene_name"]]
        ids = np.asarray(list(entry["context"]) + list(entry["target"]))
        images, c2ws, intrinsics = self.get_frames_data(scene, ids, rng)
        return {
            "images_mv": np.asarray(images),
            "cameras_mv": self.process_cameras(c2ws, intrinsics),
            "text_mv": "",
            "dataset_name_mv": self.dataset_name,
            "scene_name_mv": scene["scene_name"],
            "num_context": len(entry["context"]),
        }
