"""A cell over several ranks: small runs of ``prometheus.train_s2_dp4`` over
2 ``gloo`` ranks on the CPU through ``ranks.launch`` (``rank_run.py``, as
``run.py`` runs a cell over cards), sound and with planted faults; a rank
that raises ends every rank; a rank that loads JAX leaves no result; the
merge of the ranks' traces and the
collective readers on synthetic summaries; and a recorded single-process
trace that reads as it did before the ranks came."""
from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from portbench import harness, trace
from portbench import manifest as mf

from .test_portbench_arithmetic import CPU, CUDA, FakeEvent, fake_prof

CELL = "prometheus.train_s2_dp4"
SCRIPT = mf.HERE / "tests" / "rank_run.py"
RUNS = {"sound": ["--trace", "1"],
        "rank_skips_reduce": ["--fault", "rank_skips_reduce"],
        "exchange_left_out": ["--fault", "exchange_left_out"],
        "raise_rank_1": ["--raise-rank", "1"],
        "raise_rank_0": ["--raise-rank", "0"],
        "jax_on_rank_1": ["--load-jax-rank", "1"]}


@pytest.fixture(scope="module")
def runs():
    """Every run of the file at once (2 processes each, one thread each):
    ``{name: (returncode, stdout, stderr, seconds)}``."""
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, str(SCRIPT), "--workload", CELL, "--seed",
         str(2 ** 31 + 9), "--world", "2", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, extra in RUNS.items()}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        out[name] = (p.returncode, stdout, stderr, time.perf_counter() - t0)
    return out


def result(run) -> dict:
    code, stdout, stderr, _ = run
    assert code == 0, stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1])


def test_sound_run_over_two_ranks_is_correct(runs):
    out = result(runs["sound"])
    assert out["correct"] is True, out["check"]
    assert out["device"]["count"] == 2 and out["attempted"] >= 1
    assert out["check"]["ranks"] == {"value": 0.0, "limit": 0.0}
    assert list(out)[-1] == "check"
    # rank 0's span readers and the per-card FLOPs; no card, no trace
    assert {"mfu.dp", "enqueue_ms_per_step.dp",
            "gc_ms_per_unit.dp"} <= set(out["metrics"])
    assert not {"allreduce_ms_per_step.dp",
                "allreduce_roofline.dp"} & set(out["metrics"])


@pytest.mark.parametrize("fault", ["rank_skips_reduce", "exchange_left_out"])
def test_fault_over_ranks_is_not_correct(runs, fault):
    out = result(runs[fault])
    assert out["correct"] is False, out["check"]
    assert out["check"]["ranks"]["value"] > 0


@pytest.mark.parametrize("rank", [1, 0])
def test_a_rank_that_raises_ends_every_rank(runs, rank):
    code, stdout, stderr, seconds = runs[f"raise_rank_{rank}"]
    assert code != 0
    assert '"correct"' not in stdout
    assert "planted: rank" in stderr
    assert seconds < 120


def test_a_rank_that_loads_jax_leaves_no_result(runs):
    code, stdout, stderr, _ = runs["jax_on_rank_1"]
    assert code == 3
    assert '"correct"' not in stdout
    assert "loaded jax in a measuring process" in stderr


class FakeRanks:
    rank, world = 0, 3

    def __init__(self, values):
        self.values = values

    def gather(self, obj):
        return self.values


def test_merge_of_rank_summaries():
    ranks = [{"busy_s": b, "classes": {"collective": c}, "kernels": {},
              "collectives": calls, "device_ops": [["k", b]],
              "idle_gaps": []}
             for b, c, calls in ((3.0, 0.6, [0.1, 0.5]),
                                 (5.0, 0.9, [0.4, 0.5]),
                                 (4.0, 0.3, [0.2, 0.1]))]
    merged = trace.merge_ranks(ranks)
    assert merged["busy_s"] == pytest.approx(4.0)
    assert merged["device_ops"] == [["k", 3.0]]         # rank 0's
    ctx = {"trace": merged, "ranks": ranks, "window_s": 10.0, "work": 2,
           "units": 2, "world": 3, "reduced_bytes": 3e9}
    read = {m: mf.metric_reader(m).read(ctx) for m in (
        "idle_share.dp", "device_ms_per_step.dp",
        "allreduce_ms_per_step.dp", "allreduce_wait_ms_per_step.dp",
        "allreduce_roofline.dp")}
    assert read["idle_share.dp"] == pytest.approx(60.0)
    assert read["device_ms_per_step.dp"] == pytest.approx(2000.0)
    # call by call, the least over the ranks: 0.1 + 0.1 s over 2 steps
    assert read["allreduce_ms_per_step.dp"] == pytest.approx(100.0)
    assert read["allreduce_wait_ms_per_step.dp"] == pytest.approx(
        1e3 * (0.6 - 0.2) / 2)
    # 3 GB at 450 GB/s a step, over 0.1 s a step
    assert read["allreduce_roofline.dp"] == pytest.approx(
        100.0 * 3e9 / 450e9 / 0.1)
    # counts that differ: the rank with the least NCCL time
    ranks[2]["collectives"] = [0.3]
    assert mf.metric_reader("allreduce_ms_per_step.dp").read(
        ctx) == pytest.approx(1e3 * 0.3 / 2)
    # one card: nothing to read
    assert mf.metric_reader("allreduce_ms_per_step.dp").read(
        {"trace": merged, "work": 2}) is None


def test_memory_peak_is_the_largest_rank_s(monkeypatch):
    import torch

    read = []
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "card")
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda d: read.append(d) or 5)
    card = torch.device("cuda", 2)
    dev = harness.device_info(card, 3, FakeRanks([1, 7, 3]))
    assert dev == {"platform": "gpu", "kind": "card", "count": 3,
                   "memory_peak_bytes": 7}
    assert read == [card]                 # each rank reads its own card
    assert harness.device_info(torch.device("cpu"), 3,
                               FakeRanks([0] * 3))["count"] == 3


def test_nccl_kernels_are_collectives():
    assert trace.kernel_class(
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)") \
        == "collective"
    ms = 1_000_000
    s = trace.summarize(fake_prof([
        FakeEvent(0, 2 * ms, "ncclDevKernel_AllReduce_Sum_f32_RING_LL",
                  CUDA),
        FakeEvent(3 * ms, 1 * ms, "void at::native::reduce_kernel", CUDA),
        FakeEvent(5 * ms, 4 * ms, "ncclDevKernel_AllReduce_Sum_f32_RING_LL",
                  CUDA)]), window_s=0.01)
    assert s["collectives"] == [pytest.approx(0.002), pytest.approx(0.004)]
    assert s["classes"]["reduction"] == pytest.approx(0.001)


# a recorded single-process trace: 97 kernels of the usual classes with
# host operations in the gaps between them
NAMES = ["void at::native::vectorized_elementwise_kernel<4>",
         "flash_fwd_kernel<64,128>", "flash_bwd_main_kernel",
         "sm90_xmma_fprop_implicit_gemm", "nvjet_hsh_128x256",
         "void at::native::reduce_kernel<512>", "cudnn::nchwToNhwcKernel",
         "multi_tensor_apply_kernel", "Memcpy DtoD", "radixSortKernel"]
HOST = ["aten::mul", "aten::conv2d", "autograd::engine::evaluate_function",
        "aten::addmm"]


def recorded_events():
    ev, t = [], 0
    for i in range(97):
        d = 1000 + (i * 7919) % 50000
        ev.append(FakeEvent(t, d, NAMES[(i * 31) % len(NAMES)], CUDA))
        gap = ((i * 104729) % 7) * 3000 + ((i % 5 == 0) * 40000)
        if gap:
            ev.append(FakeEvent(t + d - 500, gap + 1000, HOST[i % len(HOST)],
                                CPU))
        t += d + gap - (i % 3 == 0) * 300
    ev.append(FakeEvent(0, t, "unit", CPU))
    return ev


# what ``trace.summarize`` read from it before the ranks (commit b4ac9c7)
RECORDED = {
    "busy_s": 0.0024666640000000004, "launches": 97,
    "classes": {"elementwise": 0.000432287,
                "flash_attn_fwd": 0.00025274000000000005,
                "flash_attn_bwd": 0.00028193,
                "convolution": 0.00026112000000000005,
                "matmul": 0.00029031000000000006, "reduction": 0.0002695,
                "layout": 0.00024869000000000003,
                "other": 0.00023000800000000002, "sort": 0.000201279},
    "device_ops": [
        ["nvjet_hsh_128x256", 0.00029031000000000006],
        ["flash_bwd_main_kernel", 0.00028193],
        ["void at::native::reduce_kernel<512>", 0.0002695],
        ["sm90_xmma_fprop_implicit_gemm", 0.00026112000000000005],
        ["flash_fwd_kernel<64,128>", 0.00025274000000000005],
        ["cudnn::nchwToNhwcKernel", 0.00024869000000000003],
        ["Memcpy DtoD", 0.00023000800000000002],
        ["void at::native::vectorized_elementwise_kernel<4>",
         0.00022354999999999999],
        ["multi_tensor_apply_kernel", 0.00020873700000000002],
        ["radixSortKernel", 0.000201279]],
    "idle_gaps": [
        ["autograd::engine::evaluate_function", 5.8e-05],
        ["aten::mul", 5.8e-05], ["aten::conv2d", 5.7700000000000007e-05],
        ["aten::addmm", 5.5e-05], ["aten::mul", 5.5e-05],
        ["autograd::engine::evaluate_function", 5.47e-05],
        ["aten::conv2d", 5.2000000000000004e-05],
        ["autograd::engine::evaluate_function", 5.17e-05],
        ["aten::mul", 4.9000000000000005e-05],
        ["aten::conv2d", 4.9000000000000005e-05]]}


def test_recorded_single_process_trace_reads_as_before():
    s = trace.summarize(fake_prof(recorded_events()), window_s=0.01)
    assert {k: s[k] for k in RECORDED} == RECORDED
    assert s["collectives"] == []
