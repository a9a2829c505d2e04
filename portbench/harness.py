"""One run of one cell: set-up, the measured window, the per-layer
readings of a traced run, the output check, and the result line.

The window runs whole units (a batch of scenes, a training step, a video)
until ``--seconds`` have passed, and waits for the last one: a rate is all
the work completed over all the time it took. Set-up, from process start
to the window's start, includes building the modules, the seeded weights,
the kernels' build (cached in the checkout after the first run) and one
warm unit at every shape the window uses. With ``--trace 1`` the window
runs under ``torch.profiler`` and the per-layer metrics are read from it,
from the port's stage timings and from the benchmark's wrappers. After the
window the program's state is freed and the plain reference judges what
the window produced (``correct``).

Over several cards (``ranks.py``) every rank runs this with its own card;
set-up ends with a full garbage collection and a barrier on every rank;
each unit ends with its sync, as alone, and then rank 0 decides whether
the window goes on, for every rank, so that all run the same units.
``failed`` is summed over the ranks; traced, each rank reduces its own
trace and rank 0 reads the metrics from its own, with ``busy_s`` the mean
over the ranks (``trace.merge_ranks``) and every rank's summary in
``ctx["ranks"]``; the memory peak is the largest of the ranks', each read
on its own card. Alone, nothing is exchanged.
"""
from __future__ import annotations

import gc
import math
import sys
import time

import torch

from . import manifest as mf
from . import trace as tr
from .ranks import Ranks

BANNED = ("jax", "jaxlib", "flax", "prometheus_tpu")


def banned_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the port's benchmark must not
    load, compared whole (``prometheus_torch`` is not ``prometheus``...)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(BANNED))


def device_info(device: torch.device, n: int, ranks=None) -> dict:
    """The result's ``device`` over ``n`` devices; the memory peak is this
    process's card's, over ranks the largest of each rank's own card's."""
    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": n,
                "memory_peak_bytes": 0}
    peak = torch.cuda.max_memory_allocated(device)
    if ranks is not None:
        peak = max(ranks.gather(peak))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": n, "memory_peak_bytes": peak}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def read_metrics(entries: list[dict], ctx: dict, base=mf.HERE) -> dict:
    """Each per-layer metric's reader on ``ctx``; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in entries:
        value = mf.metric_reader(m["name"], base).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, *, man: dict | None = None,
             cfg: dict | None = None, mix: dict | None = None,
             base=mf.HERE, patch=None) -> dict:
    """Run ``cell`` once; returns the result dict (the last key, ``check``,
    holds each compared number beside its limit). ``cfg`` overrides the
    cell's configuration (the tests' small widths); ``patch(driver)`` is
    called once the driver is built, before its warm-up (the tests'
    planted faults); ``mix`` overrides the
    traffic (the tests' small sizes)."""
    man = man or mf.manifest()
    wl = mf.workload(man, cell)
    cfg = cfg or mf.config(wl["config"], base)
    mix = mix or mf.traffic(wl["traffic"], base)
    drv = mf.driver(mix["driver"], base).Driver(cfg, mix, seed, device)
    if patch is not None:
        patch(drv)
    drv.warmup()
    sync(device)
    ranks = Ranks.of_process()
    n_dev = ranks.world if ranks else 1
    if ranks is not None:
        # every rank starts the window from a full collection, so that the
        # ranks' collections come in step with the units they run alike
        gc.collect()
        ranks.barrier()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        drv.trace_on()
        prof.__enter__()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    units, work, failed = 0, 0, 0
    while True:
        done, ok = drv.unit(units)
        sync(device)
        units += 1
        work += done
        failed += 0 if bool(ok) else 1
        more = time.perf_counter() - t0 < seconds
        if ranks is not None:
            more = ranks.agree(more)
        if not more:
            break
    window_s = time.perf_counter() - t0
    for i, row in enumerate(getattr(drv, "timings", [])):
        print(f"unit {i} stages " + " ".join(
            f"{k} {v:.4f}" for k, v in row.items()), file=sys.stderr)
    if prof is not None:
        prof.__exit__(None, None, None)
        drv.trace_off()
    dev = device_info(device, n_dev, ranks)
    if ranks is not None:
        if len(set(ranks.gather(units))) != 1:
            raise RuntimeError("the ranks ran different numbers of units")
        failed = ranks.total(failed)
    metrics = {}
    if trace:
        summary = tr.summarize(prof, window_s) if prof else {}
        del prof
        extra = {}
        if ranks is not None:
            extra["ranks"] = ranks.gather(summary)
            summary = tr.merge_ranks(extra["ranks"])
        if ranks is None or ranks.rank == 0:
            ctx = dict(drv.layer_context(), cell=cell, units=units,
                       work=work, window_s=window_s, trace=summary, **extra)
            metrics = read_metrics(mf.per_layer(man, cell), ctx, base)
        dev.update(busy_s=summary.get("busy_s", 0.0), window_s=window_s)
    else:
        values = dict(drv.end_to_end(units, work, window_s),
                      setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in mf.end_to_end(man, cell)}
    drv.release()
    t_check = time.perf_counter()
    numbers = drv.check(mf.limits(cell, base))
    check_s = time.perf_counter() - t_check
    correct = failed == 0 and all(
        math.isfinite(v) and v <= lim for _, v, lim in numbers)
    out = {"correct": correct, "attempted": units, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = {"device_ops": summary.get("device_ops", []),
                            "idle_gaps": summary.get("idle_gaps", [])}
    out["check_s"] = check_s
    out["check"] = {name: {"value": v, "limit": lim}
                    for name, v, lim in numbers}
    return out
