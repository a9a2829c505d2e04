"""The port's tracer (``prometheus_torch/profiling.py``) on the CPU: off
outside a profiler, spans with parents and units under one, on the
profiler's clock, GC spans, host-sync counts and the sync mode restored,
and the spans of the pipeline's and the trainer's layers."""
import gc
import statistics
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from prometheus_torch import profiling
from prometheus_torch.pipeline import build_pipeline


def recording():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(spans, name):
    return [s for s in spans if s["name"] == profiling.PREFIX + name]


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.spans()            # a read after the recording unhooks


def test_off_by_default_records_nothing():
    with profiling.span("x"), profiling.span("y", unit=True, batch=2):
        gc.collect()
    t0 = profiling.now_ns()
    profiling.stage("render", t0, profiling.now_ns())
    profiling.count_graph("traj", "replayed")
    assert profiling.spans() == []
    assert profiling.counters() == {"host_syncs": {}, "graphs": {},
                                    "spans_dropped": 0}
    assert profiling.span("x") is profiling.span("x")    # the shared null


def test_nested_spans_get_parent_and_unit_ids():
    @profiling.span("leaf")
    def leaf():
        return torch.ones(4).sum()

    with recording():
        with profiling.span("batch", unit=True, batch=3):
            with profiling.span("step"):
                leaf()
            t0 = profiling.now_ns()
            with profiling.span("step"):
                leaf()
            profiling.stage("late", t0, profiling.now_ns())
        with profiling.span("train", unit=41):
            leaf()
    spans = profiling.spans()
    batch, = by_name(spans, "batch")
    first, second = by_name(spans, "step")
    stage, = by_name(spans, "stage.late")
    train, = by_name(spans, "train")
    leaves = by_name(spans, "leaf")
    assert batch["parent"] is None and batch["attrs"] == {"batch": 3}
    assert first["parent"] == batch["id"]
    # the stage closed after the fact: its parent encloses it in time, and
    # the span that ran inside it becomes its child
    assert stage["parent"] == batch["id"] and second["parent"] == stage["id"]
    assert [s["parent"] for s in leaves] == [first["id"], second["id"],
                                            train["id"]]
    assert {s["unit"] for s in (batch, first, second, stage)
            } | {leaves[0]["unit"], leaves[1]["unit"]} == {batch["unit"]}
    assert train["unit"] == leaves[2]["unit"] == 41
    assert len({s["id"] for s in spans}) == len(spans)
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]


def test_spans_share_the_profilers_clock():
    """Each span's start and end against its ``record_function`` event in
    the profile: the median of 21 within 50 us (the event's stamps are
    taken inside ``record_function``, a few us from the span's), each
    within 1 ms."""
    with recording() as prof:
        for _ in range(21):
            with profiling.span("clocked"):
                torch.ones(16).sum()
    spans = by_name(profiling.spans(), "clocked")
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == profiling.PREFIX + "clocked"),
                    key=lambda e: e.start_ns())
    assert len(spans) == len(events) == 21
    starts = [abs(s["start_ns"] - e.start_ns()) for s, e in zip(spans, events)]
    ends = [abs(s["end_ns"] - e.end_ns()) for s, e in zip(spans, events)]
    assert statistics.median(starts) < 50e3 and statistics.median(ends) < 50e3
    assert max(starts) < 1e6 and max(ends) < 1e6


def test_gc_inside_a_span_is_its_child():
    with recording():
        with profiling.span("collecting", unit=5):
            gc.collect()
    spans = profiling.spans()
    parent, = by_name(spans, "collecting")
    gcs = by_name(spans, "gc")
    assert any(g["parent"] == parent["id"] and g["unit"] == 5
               and g["attrs"]["generation"] == 2 for g in gcs)
    assert gc.callbacks.count(profiling._on_gc) == 0     # unhooked


def test_syncs_count_against_the_innermost_span(monkeypatch):
    """A sync reported inside a span counts against that span's name and
    is not shown; the sync debug mode is "warn" only while recording."""
    modes = [0]
    monkeypatch.setattr(profiling, "_sync_mode_settable", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    shown = warnings.showwarning
    with recording(), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("default")
        with profiling.span("outer"):
            with profiling.span("inner"):
                for _ in range(3):
                    warnings.warn(profiling.SYNC_WARNING
                                  + " (Triggered internally)")
            warnings.warn(profiling.SYNC_WARNING)
            assert modes[-1] == "warn"
            warnings.warn("something else")
    assert profiling.counters()["host_syncs"] == {
        "prometheus.inner": 3, "prometheus.outer": 1}
    assert modes == [0, "warn", 0]
    assert [str(w.message) for w in caught] == ["something else"]
    assert warnings.showwarning is shown
    assert not any(f[1] is not None and f[1].pattern == profiling.SYNC_WARNING
                   for f in warnings.filters)


def test_a_new_recording_replaces_the_last():
    for name in ("first", "second"):
        with recording():
            with profiling.span(name):
                pass
        assert [s["name"] for s in profiling.spans()] == [
            profiling.PREFIX + name]


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_generate_spans_its_layers(one_thread):
    pipe = build_pipeline(small=True, device="cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    kw = dict(num_views=2, num_inference_steps=2, num_traj_steps=3,
              render_size=32, image_size=32)
    plain = pipe.generate("a cabin", generator=g, **kw)
    with recording():
        out = pipe.generate("a cabin", generator=g, **kw)
    spans = profiling.spans()
    assert list(out["timings"]) == list(plain["timings"]) == [
        "encode_text", "trajectory", "sample", "decode_2d",
        "decode_gaussians", "render"]
    batch, = by_name(spans, "t2s.batch")
    assert batch["attrs"] == {"batch": 1}
    assert len(by_name(spans, "traj.step")) == 3
    assert len(by_name(spans, "sampler.step")) == 2
    for name in ("render.project", "render.bin", "render.composite"):
        assert len(by_name(spans, name)) == 1, name
    stages = {s["name"]: s for s in spans if ".stage." in s["name"]}
    assert sorted(stages) == sorted(profiling.PREFIX + "stage." + k
                                    for k in out["timings"])
    render = stages[profiling.PREFIX + "stage.render"]
    project, = by_name(spans, "render.project")
    assert project["parent"] == render["id"]
    assert all(s["unit"] == batch["unit"] for s in spans)


def test_train_step_spans_its_parts(one_thread):
    from prometheus_torch.train import build_trajdit_trainer

    trainer = build_trajdit_trainer(small=True, device="cpu", batch_size=2)
    step = trainer.state.step
    with recording():
        trainer.step()
    spans = profiling.spans()
    top, = by_name(spans, "train.step")
    assert top["unit"] == step and trainer.state.step == step + 1
    for part in ("forward", "backward", "clip", "optimizer", "ema"):
        s, = by_name(spans, "train." + part)
        assert s["parent"] == top["id"] and s["unit"] == step
