"""The batch loader (``prometheus_tpu/datasets/loader.py``) in PyTorch's
idiom: a ``torch.utils.data.DataLoader`` over a map-style dataset, with

- ``ShuffledBatchSampler``: the JAX loader's order. Epoch ``e`` (counted
  from 1, advanced each time the loader is iterated) shuffles
  ``arange(len)`` with ``np.random.default_rng(seed + e)`` and drops the
  last partial batch;
- ``collate``: each array key stacked into a tensor (what
  ``torch.utils.data.default_collate`` gives), numbers into a tensor, and
  anything else (captions, names, per-item caption lists) kept as a list
  of the items' values, untransposed;
- ``num_workers`` worker processes forked from a fork server, a fresh
  single-threaded process that has imported this package: forking the
  caller itself would copy the locks its other threads hold (CUDA's, the
  pinned copies, JAX's in the parity tests), and a child that needs one
  waits for ever; spawning starts each worker from a bare interpreter
  (20 s more a run on the card, PERF.md). The dataset is pickled to the
  workers. An exception in a worker is raised again in the caller;
  ``pin_memory`` serves ``non_blocking`` copies to the card. The fork
  server keeps the environment it started with, so each worker takes the
  data plane's switches (``DATA_PLANE_ENV``: ``PROMETHEUS_NATIVE``,
  ``PROMETHEUS_JPEG_DRAFT``) from the caller's environment at the time the
  loader was made, as the JAX loader's threads read their process's.
"""
from __future__ import annotations

import functools
import multiprocessing
import os

import numpy as np
import torch
from torch.utils.data import DataLoader, Sampler


class ShuffledBatchSampler(Sampler):
    """Batches of indices of ``range(n)`` in the JAX loader's (default)
    order: shuffled, the last partial batch dropped."""

    def __init__(self, n: int, batch_size: int, seed: int = 0):
        self.n, self.batch_size, self.seed = n, batch_size, seed
        self.epoch = 0

    def __len__(self) -> int:
        return self.n // self.batch_size

    def __iter__(self):
        self.epoch += 1
        idx = np.arange(self.n)
        np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        for s in range(0, len(self) * self.batch_size, self.batch_size):
            yield idx[s:s + self.batch_size].tolist()


def collate(items: list[dict]) -> dict:
    out: dict = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[k] = torch.from_numpy(np.stack(vals))
        elif isinstance(vals[0], (int, float, np.floating, np.integer)):
            out[k] = torch.as_tensor(np.asarray(vals))
        else:
            out[k] = vals
    return out


DATA_PLANE_ENV = ("PROMETHEUS_NATIVE", "PROMETHEUS_JPEG_DRAFT")


def _set_env(env: dict, worker_id: int) -> None:
    for k in DATA_PLANE_ENV:
        if env.get(k) is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = env[k]


def make_loader(dataset, batch_size: int, *, num_workers: int = 4,
                seed: int = 0, pin_memory: bool = False) -> DataLoader:
    """A ``DataLoader`` of ``dataset`` (pickled to each worker) in
    ``ShuffledBatchSampler`` order; ``num_workers=0`` loads in the calling
    process."""
    ctx = None
    if num_workers > 0:
        ctx = multiprocessing.get_context("forkserver")
        # read when the process's fork server starts (its first loader)
        ctx.set_forkserver_preload(["prometheus_torch.datasets"])
    return DataLoader(
        dataset, batch_sampler=ShuffledBatchSampler(
            len(dataset), batch_size, seed),
        num_workers=num_workers, collate_fn=collate, pin_memory=pin_memory,
        multiprocessing_context=ctx,
        worker_init_fn=functools.partial(
            _set_env, {k: os.environ.get(k) for k in DATA_PLANE_ENV}))
