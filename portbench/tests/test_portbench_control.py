"""On the card: the output check's two readings at a cell's own widths.
The program's numbers stay under the cell's limits and the control's (the
plain reference one precision step below the configuration) break at
least one, on one seed with the traffic cut to its smallest unit. Run on
the card with ``python -m pytest portbench/tests -m gpu``."""
from __future__ import annotations

import pytest
import torch

from portbench import calibrate
from portbench import manifest as mf

CUT = {"t2s_b4": dict(batch=1), "t2s_b4_orbitcams": dict(batch=1),
       "orbit_512": dict(frames=16, compare_frames=2, scenes=1),
       "train_s2_b8": dict(batch=2, pool=3),
       "train_s2_dp4": dict(batch=2, pool=3)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in
                                  mf.manifest()["workloads"]])
def test_program_passes_and_control_fails(name, card):
    wl = mf.workload(mf.manifest(), name)
    mix = dict(mf.traffic(wl["traffic"]), **CUT[wl["traffic"]])
    limits = {k: v for k, v in mf.limits(name).items() if k != "from"}
    got = {r["kind"]: r["numbers"] for r in calibrate.readings(
        name, [7], [7], card, mix=mix)}
    assert all(got["program"][k] <= lim for k, lim in limits.items()), got
    assert any(got["control"][k] > lim for k, lim in limits.items()), got
