"""``BENCHMARK.json`` against the benchmark's contract, and the lookup of a
cell's pieces by name: a new cell, configuration, traffic mix, driver and
per-layer metric are found from their files alone."""
from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness
from portbench import manifest as mf

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
MAN = mf.manifest()


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert isinstance(MAN["run_seconds"], int)
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"]
                         + MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda e: e["name"])
def test_names_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_unique_names():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in MAN[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_metrics():
    names = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in names
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in MAN["workloads"]:
        got = {m["name"] for m in mf.end_to_end(MAN, w["name"])}
        assert "setup_s" in got and len(got) >= 2, w["name"]
        assert mf.per_layer(MAN, w["name"]), w["name"]


def test_per_layer_metrics():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert m["source"] in SOURCES
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", []):
            assert cell in cells
            moved = {x["name"] for x in mf.end_to_end(MAN, cell)}
            assert m["moves"] in moved, (m["name"], cell)
        assert (mf.HERE / "metrics" / f"{m['name']}.py").is_file()


def test_cells_resolve():
    configs = {c["name"]: c for c in MAN["configs"]}
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4)
        cfg = configs[w["config"]]
        path = mf.ROOT / cfg["file"]
        assert path.is_file() and cfg["file"].startswith("portbench/")
        body = mf.load_json(path)
        assert body["reduced"] == cfg["reduced"]
        mix = mf.traffic(w["traffic"])
        assert (mf.HERE / "drivers" / f"{mix['driver']}.py").is_file()
        # a limits file may say where its limits came from
        assert set(mf.limits(w["name"])) - {"from"} == set(
            mf.driver(mix["driver"]).NUMBERS)
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(
        1, len(MAN["workloads"]) // 4)


def test_banned_modules_compare_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "prometheus_tpu_like", types.ModuleType(
        "prometheus_tpu_like"))
    assert "prometheus_tpu_like" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert harness.banned_modules() == ["jax"]


NEW_DRIVER = '''
import torch

NUMBERS = ("echo",)


class Driver:
    def __init__(self, cfg, mix, seed, device):
        self.n, self.seed = mix["per_unit"], seed

    def warmup(self):
        pass

    def unit(self, i):
        return self.n, torch.tensor(True)

    def end_to_end(self, units, work, window_s):
        return {"echo_per_s": work / window_s}

    def trace_on(self):
        pass

    def trace_off(self):
        pass

    def layer_context(self):
        return {"answer": 42.0}

    def release(self):
        pass

    def check(self, limits):
        return [("echo", 0.0, limits["echo"])]
'''


def test_new_cell_found_from_files(tmp_path: Path):
    """A cell added with a configuration, a traffic mix, a driver, a metric
    reader and its limits, as files only, runs through the harness."""
    base = tmp_path / "portbench"
    for sub in ("configs", "traffic", "drivers", "metrics", "limits"):
        (base / sub).mkdir(parents=True)
    (base / "configs" / "toy.json").write_text('{"name": "toy"}')
    (base / "traffic" / "toy_mix.json").write_text(
        '{"driver": "toy_driver", "per_unit": 3}')
    (base / "drivers" / "toy_driver.py").write_text(NEW_DRIVER)
    (base / "metrics" / "answer.toy.py").write_text(
        "def read(ctx):\n    return ctx['answer']\n")
    (base / "metrics" / "nothing.toy.py").write_text(
        "def read(ctx):\n    return None\n")
    (base / "limits" / "toy.cell.json").write_text('{"echo": 0.5}')
    man = dict(MAN, workloads=MAN["workloads"] + [
        {"name": "toy.cell", "config": "toy", "traffic": "toy_mix",
         "chips": 1, "why": "a test"}],
        end_to_end=MAN["end_to_end"] + [
        {"name": "echo_per_s", "unit": "1/s", "better": "higher",
         "bound": 0.05, "source": "host_clock", "workloads": ["toy.cell"]}],
        per_layer=MAN["per_layer"] + [
        {"name": n, "unit": "s", "better": "lower", "source": "host_clock",
         "layer": "Toy", "moves": "echo_per_s", "workloads": ["toy.cell"]}
        for n in ("answer.toy", "nothing.toy")])
    import time

    import torch

    for trace in (False, True):
        out = harness.run_cell("toy.cell", 5, 0.05, trace,
                               torch.device("cpu"), time.perf_counter(),
                               man=man, base=base)
        assert out["correct"] and out["failed"] == 0
        assert list(out)[-1] == "check"
        if trace:
            assert out["metrics"] == {"answer.toy": {"value": 42.0,
                                                     "unit": "s"}}
        else:
            assert set(out["metrics"]) == {"echo_per_s", "setup_s"}
            work = out["attempted"] * 3
            assert out["metrics"]["echo_per_s"]["value"] > 0
            assert work >= 3
    shutil.rmtree(base)
