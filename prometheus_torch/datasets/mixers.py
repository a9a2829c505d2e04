"""Dataset mixers (``prometheus_tpu/datasets/mixers.py``).

- ``JointDataset`` merges one item of each of its heterogeneous children
  into one dict (a multi-view scene plus a batch of text-to-image images an
  iteration); the children's keys must not overlap.
- ``ProbDataset`` draws one same-format child an index by weight from
  ``random.Random(idx)`` and falls through the others, in the order of that
  draw, when the chosen child fails.
"""
from __future__ import annotations

import random

import numpy as np
from torch.utils.data import Dataset


class JointDataset(Dataset):
    def __init__(self, datasets: list, fake_length: int = -1):
        self.datasets = datasets
        self.fake_length = fake_length

    def __len__(self) -> int:
        if self.fake_length > 0:
            return self.fake_length
        return max(len(d) for d in self.datasets)

    def __getitem__(self, idx: int) -> dict:
        out: dict = {}
        for d in self.datasets:
            item = d[idx % len(d)]
            overlap = set(item) & set(out)
            if overlap:
                raise KeyError(f"joint children overlap on keys {overlap}")
            out.update(item)
        return out


class ProbDataset(Dataset):
    def __init__(self, datasets: list, probs: list[float] | None = None,
                 fake_length: int = -1):
        self.datasets = datasets
        p = np.asarray(probs if probs is not None
                       else [1.0] * len(datasets), np.float64)
        self.probs = p / p.sum()
        self.fake_length = fake_length

    def __len__(self) -> int:
        if self.fake_length > 0:
            return self.fake_length
        return sum(len(d) for d in self.datasets)

    def __getitem__(self, idx: int):
        rng = random.Random(idx)
        order = list(np.argsort([-rng.random() * w for w in self.probs]))
        first = rng.choices(range(len(self.datasets)),
                            weights=list(self.probs))[0]
        order.remove(first)
        for child in [first] + order:
            try:
                return self.datasets[child][idx % len(self.datasets[child])]
            except Exception:
                continue
        raise RuntimeError("all ProbDataset children failed")
