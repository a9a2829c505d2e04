"""The output check catches a broken timed path: a whole small run of each
cell on the CPU (the look for a card skipped), with one of ``faults.py``'s
faults planted in the program underneath, must come out ``correct:
false``; the same run without a fault comes out ``correct: true``."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import harness
from portbench.faults import FAULTS

from .small import cell, manifest_with

CPU = torch.device("cpu")
CELLS = {"prometheus.t2s_b4": ("step_unchanged", "half_batch", "altered"),
         "gmldm.t2s_b4": ("step_unchanged", "half_batch", "altered"),
         "prometheus.orbit_512": ("half_batch", "altered"),
         "prometheus.train_s2_b8": ("step_unchanged", "half_batch"),
         # alone; over ranks, with its own faults: test_portbench_ranks.py
         "prometheus.train_s2_dp4": ("step_unchanged", "half_batch")}


def run(name, patch):
    cfg, mix = cell(name)
    return harness.run_cell(name, 11, 0.01, False, CPU, time.perf_counter(),
                            man=manifest_with(name), cfg=cfg, mix=mix,
                            patch=patch)


@pytest.mark.parametrize("name,fault", [(c, f) for c, fs in CELLS.items()
                                        for f in fs])
def test_fault_is_not_correct(name, fault):
    holder = {}

    def patch(drv):
        holder["drv"] = drv
        FAULTS[fault](drv)

    try:
        out = run(name, patch)
    finally:
        restore = getattr(holder.get("drv"), "restore", None)
        if restore is not None:
            setattr(restore[0], "render_gaussians", restore[1])
    assert out["correct"] is False, out["check"]


@pytest.mark.parametrize("name", list(CELLS))
def test_sound_small_run_is_correct(name):
    out = run(name, None)
    assert out["correct"] is True, out["check"]
