"""Text-to-image single-view dataset (``prometheus_tpu/datasets/t2i.py``),
SAM-1B / JourneyDB style: captioned flat image collections, ``images_per_iter``
images an item for the single-view branch of stage-2 training, with the
caption clean-up (boilerplate prefixes stripped, whitespace collapsed).

The annotation is a json list of ``{"file", "caption"}``, a json dict
``{file: caption}``, or the reference's sharded
``filenames_and_captions_*.csv`` metadata (``[Image Name, Image Path,
Caption]`` rows). The caption list is plain Python, pickled to each of the
loader's worker processes.
"""
from __future__ import annotations

import csv
import glob
import os
import re

import numpy as np

from .base import BaseDataset, load_annotation
from .file_readers import make_reader
from .transforms import decode_crop_resize_normalize

_BOILERPLATE = re.compile(
    r"^(the (image|photo) (shows|depicts|features|captures)|"
    r"this (image|photo) (shows|depicts|features)|a photo of)\s*",
    re.IGNORECASE,
)


def clean_caption(text: str) -> str:
    text = _BOILERPLATE.sub("", text.strip())
    text = re.sub(r"\s+", " ", text)
    return text[:1].upper() + text[1:] if text else text


def _read_csv(path: str) -> list[dict]:
    out = []
    with open(path, newline="", encoding="utf-8") as fp:
        rows = csv.reader(fp)
        next(rows, None)                                   # header
        for r in rows:
            if len(r) >= 3:
                out.append({"file": r[1], "caption": r[2]})
    return out


def load_t2i_annotation(ann_path: str) -> list[dict]:
    """A json list or dict, a CSV file, or a directory of CSV shards (at
    its top or under ``metadata/``) -> ``[{"file", "caption"}, ...]``."""
    if os.path.isdir(ann_path):
        shards = sorted(
            glob.glob(os.path.join(ann_path, "filenames_and_captions_*.csv"))
            or glob.glob(os.path.join(ann_path, "metadata",
                                      "filenames_and_captions_*.csv")))
        if not shards:
            raise FileNotFoundError(
                f"no annotations.json or CSV shards under {ann_path}")
        return [item for s in shards for item in _read_csv(s)]
    if ann_path.endswith(".csv"):
        return _read_csv(ann_path)
    ann = load_annotation(ann_path)
    if isinstance(ann, dict):
        ann = [{"file": k, "caption": v} for k, v in sorted(ann.items())]
    return ann


class Text2ImageDataset(BaseDataset):
    """``images_sv (M, 3, H, W)`` and ``text_sv`` (M captions) an item: the
    ``M = images_per_iter`` images from ``idx`` on."""

    def __init__(self, root_dir: str, annotation_path: str | None = None,
                 images_per_iter: int = 4, drop_text_p: float = 0.0, **kw):
        kw.setdefault("dataset_name", "T2I")
        super().__init__(**kw)
        self.root_dir = root_dir
        self.reader = make_reader(root_dir)
        self.images_per_iter = images_per_iter
        self.drop_text_p = drop_text_p
        ann_path = annotation_path or os.path.join(root_dir,
                                                   "annotations.json")
        if not os.path.exists(ann_path) and annotation_path is None:
            ann_path = root_dir                    # CSV-shard discovery
        self.items = load_t2i_annotation(ann_path)

    def inner_len(self) -> int:
        return len(self.items)

    def get_raw_data(self, idx: int, rng):
        images, texts = [], []
        for k in range(self.images_per_iter):
            item = self.items[(idx + k) % len(self.items)]
            img, _ = decode_crop_resize_normalize(
                self.reader.fetch(item["file"]), self.img_size)
            images.append(img)
            cap = clean_caption(item.get("caption", ""))
            if rng.random() < self.drop_text_p:
                cap = ""
            texts.append(cap)
        return {"images_sv": np.stack(images), "text_sv": texts}
