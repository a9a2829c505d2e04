"""Metric and snapshot logging (``prometheus_tpu/logging_utils.py``):
JSONL metrics and PNG / GIF snapshots under ``<log_dir>/snapshots/``, with
a wandb run attached only when asked for (``use_wandb``) and importable;
otherwise, or when it fails to start, the files alone (it says so)."""
from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np

from .utils.image import ImageGrid, save_gif, save_image


class MetricLogger:
    def __init__(self, log_dir: str, use_wandb: bool = False,
                 wandb_kwargs: dict | None = None):
        self.log_dir = log_dir
        self.t0 = time.time()
        self._wandb = None
        os.makedirs(os.path.join(log_dir, "snapshots"), exist_ok=True)
        self.metrics_path = os.path.join(log_dir, "metrics.jsonl")
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(dir=log_dir, **(wandb_kwargs or {}))
            except Exception as e:
                print(f"[logger] wandb unavailable ({e}); JSONL only")

    def _path(self, name: str, step: int, ext: str) -> str:
        return os.path.join(self.log_dir, "snapshots",
                            f"{step:09d}_{name.replace('/', '_')}.{ext}")

    def log_metrics(self, metrics: dict[str, Any], step: int):
        line = {"step": step, "wall": round(time.time() - self.t0, 2)}
        for k, v in metrics.items():
            try:
                line[k] = float(v)
            except (TypeError, ValueError):
                line[k] = str(v)
        with open(self.metrics_path, "a") as fp:
            fp.write(json.dumps(line) + "\n")
        if self._wandb is not None:
            self._wandb.log(line, step=step)

    def log_image(self, name: str, image: np.ndarray, step: int):
        """``image``: uint8 (H, W, 3) -> ``snapshots/<step>_<name>.png``."""
        save_image(image, self._path(name, step, "png"))
        if self._wandb is not None:
            import wandb

            self._wandb.log({name: wandb.Image(image)}, step=step)

    def log_gif(self, name: str, frames, step: int, duration_ms: int = 100):
        """``frames``: uint8 (H, W, 3) each, e.g. the views of one sampled
        scene -> ``snapshots/<step>_<name>.gif``."""
        path = self._path(name, step, "gif")
        save_gif(frames, path, duration_ms=duration_ms)
        if self._wandb is not None:
            import wandb

            self._wandb.log({name: wandb.Video(path, format="gif")},
                            step=step)

    def log_grid(self, name: str, rows, step: int, spacing: int = 2):
        """``rows``: lists of uint8 (H, W, 3), e.g. [ground truth,
        prediction, depth] -> one grid image."""
        grid = ImageGrid(len(rows), max(len(r) for r in rows),
                         spacing=spacing)
        for i, row in enumerate(rows):
            for j, img in enumerate(row):
                grid.add(i, j, img)
        self.log_image(name, grid.compose(), step)

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
