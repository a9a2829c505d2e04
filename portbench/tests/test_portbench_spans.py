"""The readers of the port's own spans and counters: a small traced run
of each cell on the CPU reports each of them with a finite value, and
each reads None where the tracer recorded nothing or the program has no
tracer."""
from __future__ import annotations

import math
import time

import pytest
import torch

from portbench import harness
from portbench import manifest as mf

from .small import cell

SPAN_METRICS = {
    "prometheus.t2s_b4": ("traj_step_ms.t2s", "render_prep_share.t2s",
                          "host_syncs_per_unit.t2s", "gc_ms_per_unit.t2s"),
    "gmldm.t2s_b4": ("render_prep_share.t2s", "host_syncs_per_unit.t2s",
                     "gc_ms_per_unit.t2s"),
    "prometheus.train_s2_b8": ("enqueue_ms_per_step.train",
                               "host_syncs_per_unit.train",
                               "gc_ms_per_unit.train"),
    "prometheus.train_s2_dp4": ("enqueue_ms_per_step.dp",
                                "host_syncs_per_unit.dp",
                                "gc_ms_per_unit.dp")}
NAMES = sorted({m for ms in SPAN_METRICS.values() for m in ms})


@pytest.mark.parametrize("name", list(SPAN_METRICS))
def test_traced_small_run_reports_the_span_metrics(name):
    cfg, mix = cell(name)
    out = harness.run_cell(name, 2 ** 31 + 5, 0.01, True, torch.device("cpu"),
                           time.perf_counter(), cfg=cfg, mix=mix)
    listed = {m["name"] for m in mf.per_layer(mf.manifest(), name)}
    assert set(SPAN_METRICS[name]) <= listed
    for metric in SPAN_METRICS[name]:
        assert metric in out["metrics"], metric
        value = out["metrics"][metric]["value"]
        assert math.isfinite(value) and value >= 0, (metric, value)
        if metric.startswith("render_prep_share"):
            assert 0 < value <= 100


@pytest.mark.parametrize("metric", NAMES)
def test_no_spans_read_none(metric, monkeypatch):
    from prometheus_torch import profiling

    ctx = {"units": 3, "work": 12, "window_s": 50.0, "timings": []}
    profiling.reset()
    assert mf.metric_reader(metric).read(ctx) is None
    # an older program, without the tracer
    monkeypatch.delattr(profiling, "spans")
    assert mf.metric_reader(metric).read(ctx) is None
