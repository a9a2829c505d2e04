"""Profiling and step timing on the card (``prometheus_tpu/profiling.py``).

- ``trace(log_dir)``: ``torch.profiler`` over the enclosed block (CPU and,
  where a card is visible, CUDA activity), written as a Chrome / Perfetto
  trace, ``<log_dir>/trace.json``;
- ``annotate(name)``: a named range inside such a trace
  (``torch.profiler.record_function``);
- ``StepTimer``: wall-clock step times with EMA smoothing and a rate;
  ``measure(sync=...)`` waits for the card that holds ``sync`` before it
  stops the clock, so a step's queued kernels are inside its time;
- ``device_memory_stats()``: bytes in use, the card's size and the peak
  bytes in use, for each visible card (``torch.cuda.memory_stats``).
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str = "prometheus_trace"):
    """Profile the enclosed block; yields ``log_dir``, where the trace is
    written as ``TRACE_FILE`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A named range that shows up inside ``trace``'s profile."""
    return torch.profiler.record_function(name)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class StepTimer:
    """Wall-clock step timer with EMA smoothing and throughput helpers."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg: float | None = None
        self.last: float | None = None       # the latest step's seconds
        self._t0: float | None = None
        self.steps = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = self.last = time.perf_counter() - self._t0
        self.avg = dt if self.avg is None else \
            self.ema * self.avg + (1 - self.ema) * dt
        self.steps += 1
        return dt

    @contextlib.contextmanager
    def measure(self, sync=None):
        """Time the block; ``sync`` (a tensor, or a list, tuple or dict of
        them) makes the clock stop only once every card holding one of its
        tensors has finished its queued work."""
        self.start()
        yield
        for dev in {t.device for t in _tensors(sync) if t.is_cuda}:
            torch.cuda.synchronize(dev)
        self.stop()

    def rate(self, items_per_step: float) -> float:
        """Items a second at the current EMA step time."""
        return items_per_step / self.avg if self.avg else 0.0


def device_memory_stats() -> list[dict]:
    """One dict per visible card: ``device``, ``bytes_in_use``,
    ``bytes_limit`` (the card's memory) and ``peak_bytes_in_use``, as the
    caching allocator counts them; an empty list without a card."""
    out = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i}",
            "bytes_in_use": s.get("allocated_bytes.all.current"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
        })
    return out
