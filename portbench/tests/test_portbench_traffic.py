"""The traffic is a function of the seed: the prompt stream, the token ids,
each unit's noise and cameras, and the orbit cell's scenes and paths."""
from __future__ import annotations

import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from portbench import common, scenes
from portbench import manifest as mf
from portbench.tokenizer import fixed_tokens

from .small import cell

CPU = torch.device("cpu")


def test_fixed_tokens_are_crc32_ids():
    ids = fixed_tokens(["a red car", ""])
    assert ids.shape == (2, 77) and ids.dtype == np.int32
    want = [49406] + [zlib.crc32(w.encode()) % 49406
                      for w in ("a", "red", "car")] + [49407]
    assert ids[0, :5].tolist() == want
    assert (ids[0, 5:] == 49407).all()
    assert ids[1, :2].tolist() == [49406, 49407]


def test_fixed_tokens_same_in_every_process():
    code = ("import sys; sys.path.insert(0, %r); from portbench.tokenizer "
            "import fixed_tokens; print(fixed_tokens(['a cozy wooden cabin'])"
            ".tolist())" % str(mf.ROOT))
    outs = {subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, check=True,
                           env=dict(os.environ, PYTHONHASHSEED=s)).stdout
            for s in ("1", "2")}
    assert len(outs) == 1


def test_prompt_stream():
    a, b = common.PromptStream(7, 4), common.PromptStream(7, 4)
    c = common.PromptStream(2**31 + 11, 4)
    assert [a(i) for i in range(25)] == [b(i) for i in range(25)]
    assert a(0) != c(0)
    assert len(set(a(0))) == 4
    seen = {p for i in range(20) for p in a(i)}      # 80 prompts, wrapped
    assert len(seen) == 80


def test_sub_seeds_cover_large_seeds():
    s = {common.sub_seed(2**31 + 5, 3, i) for i in range(100)}
    assert len(s) == 100 and all(0 <= x < 2**63 for x in s)


@pytest.mark.parametrize("name", ["prometheus.t2s_b4", "gmldm.t2s_b4"])
def test_unit_inputs_depend_on_the_seed_alone(name):
    cfg, mix = cell(name)
    drv = lambda seed: mf.driver(mix["driver"]).Driver(cfg, mix, seed, CPU)
    a, b, c = drv(3), drv(3), drv(4)
    assert a.compare_units == b.compare_units and 0 in a.compare_units
    assert a.compare_steps == b.compare_steps
    if name.startswith("prometheus"):
        for x, y in zip(a._inputs(1), b._inputs(1)):
            assert torch.equal(x, y)
        assert not torch.equal(a._inputs(1)[1], c._inputs(1)[1])
        assert not torch.equal(a._inputs(1)[1], a._inputs(2)[1])
    else:
        assert torch.equal(a._cameras(1), b._cameras(1))
        assert not torch.equal(a._cameras(1), c._cameras(1))
    for p, q in zip(a.pipe.mvldm.model.parameters() if name.startswith(
            "prometheus") else a.model.parameters(),
            b.pipe.mvldm.model.parameters() if name.startswith(
            "prometheus") else b.model.parameters()):
        assert torch.equal(p, q)


def test_orbit_scenes_and_paths():
    cfg, mix = cell("prometheus.orbit_512")
    Drv = mf.driver("orbit").Driver
    a, b = Drv(cfg, mix, 9, CPU), Drv(cfg, mix, 9, CPU)
    for s, t in zip(a.scenes, b.scenes):
        for x, y in zip(s, t):
            assert torch.equal(x, y)
    assert torch.equal(a._dense(3), b._dense(3))
    assert not torch.equal(a._dense(3), a._dense(4))
    assert a.compare_frames == b.compare_frames
    dense = a._dense(0)
    assert dense.shape == (1, 29, 18)
    g = torch.Generator().manual_seed(1)
    scene = scenes.make_trained_stats_scene(dense[0, :1], g, n_gaussians=64)
    assert [t.shape for t in scene] == [(1, 64, 3), (1, 64, 1, 3),
                                        (1, 64, 1), (1, 64, 3), (1, 64, 4)]
