"""Port parity for the legacy (Director3D-era) dataset formats of the
GM-LDM path: blender ``transforms.json`` renders and CO3D's
``frame_annotations.jgz``, ingested by the repo's ``tools/build_metadata.py
blender|co3d`` (run as a subprocess; those subcommands import numpy only)
and read through the port's classes and JAX's, and the shape of a
``LegacyMixingDataset`` item. The scenes are written as
``tests/test_legacy_datasets.py`` writes them.

Both packages run with ``PROMETHEUS_NATIVE=0`` (the process's variable),
so both decode through PIL; items are equal to ``atol 1e-6``
(``test_torch_datasets.py::assert_items_equal``) for the same
``random.Random`` draws.
"""
import gzip
import json
import os
import pickle
import random
import subprocess
import sys

import numpy as np
import pytest

import prometheus_tpu.datasets as jds
import prometheus_torch.datasets as tds
from test_legacy_datasets import (_orbit_pose,
                                  _p3d_viewpoint_from_opencv_w2c,
                                  _write_img)
from test_torch_datasets import assert_items_equal

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")


@pytest.fixture(autouse=True)
def pure_python_decode(monkeypatch):
    monkeypatch.setenv("PROMETHEUS_NATIVE", "0")


def build_metadata(kind: str, root: str, out: str, *extra):
    res = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "build_metadata.py"), kind,
         "--root", root, "--out", out, *extra],
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def assert_same_items(port, ref, n: int):
    assert len(port) == len(ref)
    for idx in range(n):
        got = port.get_raw_data(idx, random.Random(idx))
        want = ref.get_raw_data(idx, random.Random(idx))
        assert_items_equal(got, want)


@pytest.mark.parametrize("cls", ["ShapeNetDataset", "OmniObject3DDataset",
                                 "BlenderRendersDataset"])
def test_blender_renders_match_jax(tmp_path, cls):
    root = os.path.join(tmp_path, "renders")
    for scene in ("car_001", "chair_002"):
        frames = []
        for i in range(6):
            rel = f"r_{i}"
            _write_img(os.path.join(root, scene, f"{rel}.png"), i)
            frames.append({"file_path": rel,
                           "transform_matrix": _orbit_pose(i * 1.0).tolist()})
        with open(os.path.join(root, scene, "transforms.json"), "w") as fp:
            json.dump({"camera_angle_x": 0.9, "frames": frames}, fp)
    ann = os.path.join(tmp_path, "blender.pkl")
    build_metadata("blender", root, ann, "--prompt_suffix", "3D asset")
    kw = dict(annotation_path=ann, img_size=32, num_input_views=2,
              num_novel_views=2)
    port = tds.get_dataset(cls)(root, **kw)
    ref = getattr(jds, cls)(root, **kw)
    assert port.dataset_name == ref.dataset_name
    assert port.pose_convention == "opengl"
    item = port.get_raw_data(0, random.Random(0))
    assert item["images_mv"].shape == (4, 3, 32, 32)
    assert "3D asset" in item["text_mv"]
    assert_same_items(port, ref, 2)


def test_co3d_matches_jax(tmp_path):
    root = os.path.join(tmp_path, "co3d")
    H = W = 48
    frames_meta = []
    for i in range(5):
        c2w = _orbit_pose(0.8 * i, r=3.0)
        flip = np.diag([1.0, -1.0, -1.0])
        R_cv_c2w = c2w[:3, :3] @ flip
        R_p3d, T_p3d = _p3d_viewpoint_from_opencv_w2c(
            R_cv_c2w.T, -R_cv_c2w.T @ c2w[:3, 3])
        rel = f"apple/seq0/images/frame{i:03d}.jpg"
        _write_img(os.path.join(root, rel), i)
        frames_meta.append({
            "sequence_name": "seq0", "frame_number": i,
            "image": {"path": rel, "size": [H, W]},
            "viewpoint": {"R": R_p3d.tolist(), "T": T_p3d.tolist(),
                          "focal_length": [2.0, 2.0],
                          "principal_point": [0.0, 0.0]},
        })
    with gzip.open(os.path.join(root, "apple", "frame_annotations.jgz"),
                   "wt") as fp:
        json.dump(frames_meta, fp)
    ann = os.path.join(tmp_path, "co3d.pkl")
    build_metadata("co3d", root, ann)
    kw = dict(annotation_path=ann, img_size=32, num_input_views=2,
              num_novel_views=2)
    port = tds.build_dataset({"module": "prometheus_torch.datasets."
                                        "CO3DDataset", "args": kw},
                             {"root_dir": root})
    ref = jds.CO3DDataset(root, **kw)
    assert port.pose_convention == "opencv"
    item = port.get_raw_data(0, random.Random(0))
    assert item["text_mv"] == "apple"
    assert np.isfinite(item["cameras_mv"]).all()
    assert_same_items(port, ref, 1)


def test_legacy_mixing_matches_jax(tmp_path):
    """An objaverse-layout scene and captioned images, merged per item:
    the port's ``__getitem__`` equals JAX's (same seed a worker draws)."""
    oroot = os.path.join(tmp_path, "objv")
    scene = "obj0"
    for i in range(4):
        _write_img(os.path.join(oroot, scene, f"{i:03d}.png"), i)
    gl2cv = np.diag([1.0, -1.0, -1.0])
    poses = [np.concatenate([_orbit_pose(1.5 * i)[:3, :3] @ gl2cv,
                             _orbit_pose(1.5 * i)[:3, 3:4]], axis=1).tolist()
             for i in range(4)]
    ann = {scene: {"frames": [f"{scene}/{i:03d}.png" for i in range(4)],
                   "poses": poses,
                   "intrinsics": [[40.0, 40.0, 24.0, 24.0]] * 4,
                   "captions": ["a toy"]}}
    apath = os.path.join(tmp_path, "objv.pkl")
    with open(apath, "wb") as fp:
        pickle.dump(ann, fp)
    troot = os.path.join(tmp_path, "t2i")
    for i in range(3):
        _write_img(os.path.join(troot, f"im{i}.png"), 10 + i)
    with open(os.path.join(troot, "annotations.json"), "w") as fp:
        json.dump([{"file": f"im{i}.png", "caption": f"cap {i}"}
                   for i in range(3)], fp)
    kw = dict(objaverse_kwargs=dict(root_dir=oroot, annotation_path=apath,
                                    num_input_views=2, num_novel_views=0,
                                    sample_rate=-1),
              t2i_kwargs=dict(root_dir=troot, images_per_iter=2),
              img_size=32)
    port = tds.LegacyMixingDataset(**kw)
    ref = jds.LegacyMixingDataset(**kw)
    item = port[0]
    assert item["images_mv"].shape[0] == 2
    assert item["images_sv"].shape == (2, 3, 32, 32)
    assert "text_mv" in item and "text_sv" in item
    assert_items_equal(item, ref[0])
