"""The reader of the tracer's ``graphs`` counter, ``traj_graph_share.t2s``:
on fake recordings, and on a small traced run on the CPU, where every
TrajDiT forward runs eagerly."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import harness
from portbench import manifest as mf

from .small import cell

METRIC = "traj_graph_share.t2s"
SPAN = {"name": "prometheus.traj.step", "start_ns": 0, "end_ns": 1}


def counters(graphs=None):
    out = {"host_syncs": {}, "spans_dropped": 0}
    if graphs is not None:
        out["graphs"] = graphs
    return out


@pytest.mark.parametrize("graphs, want", [
    ({"traj": {"captured": 1, "replayed": 100, "eager": 0}}, 100.0),
    ({"traj": {"captured": 0, "replayed": 75, "eager": 25}}, 75.0),
    ({"traj": {"captured": 0, "replayed": 0, "eager": 100}}, 0.0),
    ({}, None),
    ({"traj": {"captured": 0, "replayed": 0, "eager": 0}}, None),
    (None, None)])        # a program without the counter (the parent)
def test_reads_the_replayed_share(graphs, want, monkeypatch):
    from prometheus_torch import profiling

    monkeypatch.setattr(profiling, "spans", lambda: [SPAN])
    monkeypatch.setattr(profiling, "counters", lambda: counters(graphs))
    assert mf.metric_reader(METRIC).read({"units": 2}) == want


def test_no_recording_reads_none(monkeypatch):
    from prometheus_torch import profiling

    monkeypatch.setattr(profiling, "spans", lambda: [])
    monkeypatch.setattr(profiling, "counters", lambda: counters(
        {"traj": {"captured": 1, "replayed": 100, "eager": 0}}))
    assert mf.metric_reader(METRIC).read({"units": 2}) is None


def test_traced_small_run_on_the_cpu_reads_zero():
    name = "prometheus.t2s_b4"
    assert METRIC in {m["name"] for m in mf.per_layer(mf.manifest(), name)}
    cfg, mix = cell(name)
    out = harness.run_cell(name, 2 ** 31 + 9, 0.01, True, torch.device("cpu"),
                           time.perf_counter(), cfg=cfg, mix=mix)
    assert out["metrics"][METRIC]["value"] == 0.0
