"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the driver the mix names
(``drivers/<driver>.py``), its comparison limits (``limits/<cell>.json``)
and its per-layer metric readers (``metrics/<metric>.py``)."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as fp:
        return json.load(fp)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, base: Path = HERE) -> dict:
    return load_json(base / "configs" / f"{name}.json")


def traffic(name: str, base: Path = HERE) -> dict:
    return load_json(base / "traffic" / f"{name}.json")


def limits(cell: str, base: Path = HERE) -> dict:
    return load_json(base / "limits" / f"{cell}.json")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, base: Path = HERE):
    return load_module(base / "drivers" / f"{name}.py",
                       f"portbench_driver_{name}")


def metric_reader(name: str, base: Path = HERE):
    return load_module(base / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))


def end_to_end(man: dict, cell: str) -> list[dict]:
    """The end-to-end metrics ``cell`` reports."""
    return [m for m in man["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer(man: dict, cell: str) -> list[dict]:
    """The per-layer metrics ``cell`` reports: those that list it, and
    those without a list whose end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end(man, cell)}
    return [m for m in man["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
