"""The benchmark's arithmetic: busy and idle time from a canned trace, the
kernel classes, the kernels' bounds, and whole-unit rates."""
from __future__ import annotations

import importlib.util
import math
import types

import pytest
import torch

from portbench import bounds, trace
from portbench import manifest as mf

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class FakeEvent:
    def __init__(self, t0, dur, name, dev, note=False):
        self._t0, self._dur, self._name, self._dev = t0, dur, name, dev
        self._note = note

    def is_user_annotation(self):
        return self._note

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._dur

    def name(self):
        return self._name

    def device_type(self):
        return self._dev


def fake_prof(events):
    res = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=res))


def test_busy_is_the_union_and_gaps_are_named():
    ms = 1_000_000
    events = [
        FakeEvent(0, 10 * ms, "flash_fwd_kernel<64>", CUDA),
        FakeEvent(5 * ms, 10 * ms, "void at::vectorized_elementwise", CUDA),
        FakeEvent(40 * ms, 20 * ms, "composite_fwd_kernel", CUDA),
        FakeEvent(14 * ms, 30 * ms, "aten::nonzero", CPU),
        FakeEvent(0, 100 * ms, "unit", CPU),
        FakeEvent(0, 60 * ms, "Optimizer.step#AdamW.step", CUDA, note=True),
    ]
    s = trace.summarize(fake_prof(events), window_s=0.1)
    assert s["busy_s"] == pytest.approx(0.035)       # [0, 15) and [40, 60)
    assert s["classes"]["flash_attn_fwd"] == pytest.approx(0.010)
    assert s["classes"]["elementwise"] == pytest.approx(0.010)
    assert s["classes"]["composite_fwd"] == pytest.approx(0.020)
    assert s["device_ops"][0] == ["composite_fwd_kernel", pytest.approx(0.02)]
    assert s["idle_gaps"] == [["aten::nonzero", pytest.approx(0.025)]]
    idle = mf.metric_reader("idle_share.t2s").read(
        {"trace": s, "window_s": 0.1})
    assert idle == pytest.approx(65.0)


def test_no_device_events_reads_nothing():
    s = trace.summarize(fake_prof([]), window_s=1.0)
    assert s["busy_s"] == 0.0
    assert mf.metric_reader("idle_share.t2s").read(
        {"trace": s, "window_s": 1.0}) is None
    assert mf.metric_reader("flash_attn_fwd_roofline.t2s").read(
        {"trace": s, "attn_fwd": [(1, 1024, 5, 64)]}) is None


@pytest.mark.parametrize("name,cls", [
    ("flash_fwd_kernel<80, 128>", "flash_attn_fwd"),
    ("flash_bwd_main_kernel", "flash_attn_bwd"),
    ("composite_fwd_kernel", "composite_fwd"),
    ("nvjet_hsh_128x256", "matmul"),
    ("cudnn::nchwToNhwcKernel", "layout"),
    ("at::native::reduce_kernel", "reduction"),
    ("something_else", "other")])
def test_kernel_classes(name, cls):
    assert trace.kernel_class(name) == cls


def test_attention_bounds():
    # (64, 1024, 5, 64): 4 B H T^2 D = 85.9 GFLOP at 989 TFLOP/s = 86.9 us,
    # above the 33.6 MB of q, k, v, o at 3.35 TB/s
    b, t, h, d = 64, 1024, 5, 64
    assert bounds.attn_fwd_bound_s((b, t, h, d)) == pytest.approx(
        4 * b * h * t * t * d / 989e12)
    assert bounds.attn_bwd_bound_s((b, t, h, d)) == pytest.approx(
        10 * b * h * t * t * d / 989e12)
    # a short sequence is bound by its bytes
    small = (1, 128, 1, 16)
    assert bounds.attn_fwd_bound_s(small) == pytest.approx(
        4 * 128 * 16 * 2 / 3.35e12)
    assert bounds.composite_bound_s(1e9) == pytest.approx(27e9 / 67e12)


def test_roofline_and_mfu_readers():
    ctx = {"trace": {"classes": {"flash_attn_fwd": 2e-4}},
           "attn_fwd": [(64, 1024, 5, 64)] * 2, "flops_per_unit": 1e12,
           "units": 10, "window_s": 100.0}
    got = mf.metric_reader("flash_attn_fwd_roofline.t2s").read(ctx)
    assert got == pytest.approx(100 * 2 * bounds.attn_fwd_bound_s(
        (64, 1024, 5, 64)) / 2e-4)
    assert mf.metric_reader("mfu.t2s").read(ctx) == pytest.approx(
        100 * 1e13 / 100.0 / 989e12)


def test_stage_readers_average_over_units():
    ctx = {"timings": [{"trajectory": 1.0, "sample": 3.0,
                        "decode_gaussians": 0.25, "render": 0.5},
                       {"trajectory": 3.0, "sample": 5.0,
                        "decode_gaussians": 0.25, "render": 0.5}]}
    read = lambda n: mf.metric_reader(n).read(ctx)
    assert read("trajectory_s.t2s") == pytest.approx(2.0)
    assert read("sample_s.t2s") == pytest.approx(4.0)
    assert read("decode_render_s.t2s") == pytest.approx(0.75)
    assert mf.metric_reader("trajectory_s.t2s").read(
        {"timings": [{"denoise": 1.0}]}) is None


@pytest.mark.parametrize("driver,metric,work,scale", [
    ("t2s_pipeline", "scenes_per_min", 36, 60.0),
    ("t2s_gmldm", "scenes_per_min", 48, 60.0),
    ("orbit", "render_fps", 2400, 1.0)])
def test_whole_unit_rates(driver, metric, work, scale):
    """A rate is all the work of the whole units over all their time."""
    cls = mf.driver(driver).Driver
    got = cls.end_to_end(None, 9, work, 41.5)
    assert got == {metric: pytest.approx(scale * work / 41.5)}
    assert math.isfinite(got[metric])


def test_metric_modules_load_alone():
    for path in sorted((mf.HERE / "metrics").glob("*.py")):
        if path.name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)
