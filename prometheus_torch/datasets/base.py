"""Dataset base classes (``prometheus_tpu/datasets/base.py``): annotation
loading, retry on error, view sampling and camera processing.

- ``BaseDataset``: a map-style ``torch.utils.data.Dataset`` whose item
  ``idx`` draws its randomness from ``random.Random(idx)`` (so an item is
  the same in every process, and in both packages), retries a failing scene
  with an index drawn from that generator, and sizes its epoch by
  ``fake_length``.
- ``MultiviewDataset``: ``get_raw_data`` = parse the scene -> caption ->
  sample views (a uniform stride, or random with the first and last index
  kept) -> frames, poses and intrinsics -> ``process_cameras`` (relative to
  the first frame, translations scaled by their largest norm, rotations
  checked, too-small scenes rejected) -> the item dict.

Everything here runs on the host in numpy; items hold float32 CHW images in
[-1, 1] and ``(N, 18)`` float32 cameras.
"""
from __future__ import annotations

import json
import pickle
import random
from abc import ABC, abstractmethod

import numpy as np
from torch.utils.data import Dataset


def load_annotation(path: str):
    """Load a json / pkl / npz / txt annotation file by its extension."""
    if path.endswith(".json"):
        with open(path) as fp:
            return json.load(fp)
    if path.endswith((".pkl", ".pickle")):
        with open(path, "rb") as fp:
            return pickle.load(fp)
    if path.endswith(".npz"):
        return dict(np.load(path, allow_pickle=True))
    if path.endswith(".txt"):
        with open(path) as fp:
            return [line.strip() for line in fp if line.strip()]
    raise ValueError(f"unknown annotation format: {path}")


class BaseDataset(ABC, Dataset):
    """Map-style dataset with retry on error and fake-length epochs."""

    def __init__(self, *, img_size: int = 256, fake_length: int = -1,
                 max_retries: int = 10, debug: bool = False,
                 dataset_name: str = "base"):
        self.img_size = img_size
        self.fake_length = fake_length
        self.max_retries = max_retries
        self.debug = debug
        self.dataset_name = dataset_name

    @abstractmethod
    def inner_len(self) -> int:
        ...

    @abstractmethod
    def get_raw_data(self, idx: int, rng: random.Random):
        ...

    def __len__(self) -> int:
        return self.fake_length if self.fake_length > 0 else self.inner_len()

    def __getitem__(self, idx: int):
        rng = random.Random(idx if not self.debug else 0)
        inner = idx % max(self.inner_len(), 1)
        for _ in range(self.max_retries):
            try:
                return self.get_raw_data(inner, rng)
            except Exception:
                if self.debug:
                    raise
                inner = rng.randrange(self.inner_len())
        raise RuntimeError(
            f"{self.dataset_name}: {self.max_retries} consecutive failures")


class MultiviewDataset(BaseDataset):
    """Template for the multi-view scene datasets."""

    output_keys = ("images_mv", "cameras_mv", "text_mv",
                   "dataset_name_mv", "scene_name_mv")

    def __init__(self, *, num_input_views: int = 8, num_novel_views: int = 0,
                 sample_rate: int = -1, normalized_cameras: bool = True,
                 scene_scale_threshold: float = 0.0, use_caption: bool = True,
                 drop_text_p: float = 0.0, view_type: str = "uniform", **kw):
        super().__init__(**kw)
        self.num_input_views = num_input_views
        self.num_novel_views = num_novel_views
        self.num_views = num_input_views + num_novel_views
        self.sample_rate = sample_rate
        self.normalized_cameras = normalized_cameras
        self.scene_scale_threshold = scene_scale_threshold
        self.use_caption = use_caption
        self.drop_text_p = drop_text_p
        self.view_type = view_type

    @abstractmethod
    def parse_scene(self, idx: int) -> dict:
        """``{'scene_name', 'num_frames', ...}`` of scene ``idx``."""

    @abstractmethod
    def get_frames_data(self, scene: dict, frame_ids: np.ndarray, rng):
        """``(images (N, 3, H, W) float32, c2ws (N, 3, 4) OpenGL,
        intrinsics (N, 4) [fx, fy, cx, cy] at img_size)``."""

    def get_caption(self, scene: dict, rng) -> str:
        if not self.use_caption or rng.random() < self.drop_text_p:
            return ""
        caps = scene.get("captions") or []
        return rng.choice(caps) if caps else ""

    def sample_views(self, num_frames: int, rng) -> np.ndarray:
        n = self.num_views
        if num_frames < n:                 # repeat-pad short sequences
            ids = np.arange(num_frames)
            ids = np.concatenate([ids, rng.choices(range(num_frames),
                                                   k=n - num_frames)])
            return np.sort(np.asarray(ids))
        if self.view_type == "uniform":
            rate = self.sample_rate if self.sample_rate > 0 else max(
                num_frames // n, 1)
            rate = max(min(rate, num_frames // n), 1)
            span = rate * (n - 1) + 1
            start = rng.randrange(max(num_frames - span + 1, 1))
            return start + np.arange(n) * rate
        if self.view_type == "random":
            # a random subset with its lowest and highest index kept
            lo = rng.randrange(max(num_frames - n, 1))
            hi = min(lo + max(self.sample_rate, 1) * n, num_frames - 1)
            mid = sorted(rng.sample(range(lo + 1, max(hi, lo + 2)),
                                    k=max(n - 2, 0)))
            return np.asarray([lo] + mid + [hi])[:n]
        raise ValueError(self.view_type)

    def process_cameras(self, c2ws: np.ndarray,
                        intrinsics: np.ndarray) -> np.ndarray:
        """``(N, 3, 4)`` poses + ``(N, 4)`` intrinsics -> ``(N, 18)``
        camera vectors, in float64 numpy (``utils.cameras.normalize_poses``
        and ``check_valid_rotations`` are the tensor versions); raises on a
        scene too small or with bad rotations."""
        c2ws = np.asarray(c2ws, np.float64)
        n = c2ws.shape[0]
        bottom = np.broadcast_to(np.asarray([0.0, 0.0, 0.0, 1.0]), (n, 1, 4))
        sq = np.concatenate([c2ws, bottom], axis=1)
        if self.normalized_cameras:
            rel = (np.linalg.inv(sq[0])[None] @ sq)[:, :3, :]
            nv = self.num_input_views if self.num_input_views > 0 else n
            t_norm = float(np.linalg.norm(rel[:nv, :3, 3], axis=-1).max())
            c2ws = np.concatenate(
                [rel[:, :3, :3], rel[:, :3, 3:] / (t_norm + 1e-2)], axis=-1)
            if t_norm < self.scene_scale_threshold:
                raise ValueError(f"camera motion too small: {t_norm:.4f}")
        rots = c2ws[:, :3, :3]
        orth = np.abs(rots @ np.swapaxes(rots, -1, -2) - np.eye(3)).max()
        det = np.abs(np.linalg.det(rots) - 1.0).max()
        if not (orth < 1e-3 and det < 1e-3) or (
                np.linalg.norm(c2ws[:, :3, 3], axis=-1) > 5).any():
            raise ValueError("invalid rotation matrix or runaway translation")
        hw = np.full((n, 2), float(self.img_size), np.float32)
        return np.concatenate([c2ws.reshape(n, 12).astype(np.float32),
                               np.asarray(intrinsics, np.float32), hw],
                              axis=1)

    def get_raw_data(self, idx: int, rng):
        scene = self.parse_scene(idx)
        text = self.get_caption(scene, rng)
        frame_ids = self.sample_views(scene["num_frames"], rng)
        images, c2ws, intrinsics = self.get_frames_data(scene, frame_ids, rng)
        return {
            "images_mv": np.asarray(images),            # (N, 3, H, W)
            "cameras_mv": self.process_cameras(c2ws, intrinsics),  # (N, 18)
            "text_mv": text,
            "dataset_name_mv": self.dataset_name,
            "scene_name_mv": scene.get("scene_name", str(idx)),
        }
