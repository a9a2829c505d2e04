"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of the port. Module names are compared by their
top-level part as a whole word: ``prometheus_torch`` is not
``prometheus_tpu``."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

from portbench import manifest as mf

BANNED = {"jax", "jaxlib", "flax", "prometheus_tpu", "bench"}


def imported_tops(path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
    return tops


def test_no_source_imports_jax_or_the_jax_package():
    for path in sorted(mf.HERE.rglob("*.py")):
        assert not imported_tops(path) & BANNED, path


def test_reference_imports_nothing_of_the_port():
    for path in sorted((mf.HERE / "reference").glob("*.py")):
        assert "prometheus_torch" not in imported_tops(path), path
        assert "portbench" not in imported_tops(path), path


RUN = """
import json, sys, time, torch
sys.path.insert(0, {root!r})
from portbench import harness, manifest as mf
from portbench.tests.small import cell
for name in {cells!r}:
    cfg, mix = cell(name)
    harness.run_cell(name, 1, 0.01, True, torch.device("cpu"),
                     time.perf_counter(), cfg=cfg, mix=mix)
for path in sorted(mf.HERE.glob("metrics/*.py")):
    if not path.name.startswith("_"):
        mf.metric_reader(path.stem)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_banned_module():
    """Small runs of every cell (traced, checked) in a fresh process, then
    the top-level names in ``sys.modules``."""
    cells = [w["name"] for w in mf.manifest()["workloads"]]
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(mf.ROOT), cells=cells)],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "prometheus_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "prometheus_tpu"}
