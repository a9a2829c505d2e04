"""Port parity for the exports: ``.ply`` / ``.splat`` bytes, the image
helpers and the PNG writer against the JAX package, and the CLI
(``python -m prometheus_torch.inference``) on the CPU at the small widths.

The gaussian files must be byte-equal to the JAX writers'; the image
helpers' uint8 arrays equal; the port's PNGs, decoded by PIL, pixel-equal
to the JAX writer's (the files differ: the port writes them with the
standard library).
"""
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from prometheus_tpu.utils import gs_io as jax_gs_io
from prometheus_tpu.utils import image as jax_image
from prometheus_torch import inference
from prometheus_torch.utils import gs_io, image
from test_torch_sampler_modes import one_thread  # noqa: F401  (fixture)
from torch_dist_ranks import one_rank_group


def gaussians(rng, n=300, batched=True):
    g = (rng.normal(size=(n, 3)), rng.uniform(0, 1, size=(n, 1, 3)),
         rng.uniform(0, 1, size=(n, 1)), rng.uniform(1e-3, 0.2, size=(n, 3)),
         rng.normal(size=(n, 4)))
    g = tuple(np.asarray(a, np.float32) for a in g)
    return tuple(a[None] for a in g) if batched else g


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_ply_and_splat_bytes_equal_jax(rng, tmp_path, threshold):
    g = gaussians(rng)
    for name, ours, theirs in (("ply", gs_io.export_ply, jax_gs_io.export_ply),
                               ("splat", gs_io.export_splat,
                                jax_gs_io.export_splat)):
        a, b = tmp_path / f"port.{name}", tmp_path / f"jax.{name}"
        n_a = ours(str(a), tuple(torch.from_numpy(x) for x in g), threshold)
        n_b = theirs(str(b), g, threshold)
        assert n_a == n_b > 0
        assert a.read_bytes() == b.read_bytes()
    assert os.path.getsize(tmp_path / "port.splat") == 32 * n_a


def test_export_gaussians_and_load_ply_round_trip(rng, tmp_path):
    g = gaussians(rng, batched=False)
    gs_io.export_gaussians(str(tmp_path / "g"), g)
    back = gs_io.load_ply(str(tmp_path / "g.ply"))
    ref = jax_gs_io.load_ply(str(tmp_path / "g.ply"))
    for a, b, orig in zip(back, ref, g):
        np.testing.assert_array_equal(a, b)
        assert a.shape == (1,) + orig.shape
    # compatible mode stores logit(opacity) and log(scales): the round
    # trip is float32-exact up to those transforms
    for a, orig in zip(back, g):
        np.testing.assert_allclose(a[0], orig, rtol=1e-4, atol=1e-5)
    assert os.path.getsize(tmp_path / "g.splat") == 32 * g[0].shape[0]


def test_image_helpers_equal_jax(rng):
    img = rng.uniform(-1.2, 1.2, size=(5, 3, 12, 10)).astype(np.float32)
    post = image.postprocess_image(img)
    np.testing.assert_array_equal(post, jax_image.postprocess_image(img))
    dep = rng.uniform(-0.1, 1.1, size=(5, 12, 10)).astype(np.float32)
    for lo, hi in ((0.0, 1.0), (None, None)):
        np.testing.assert_array_equal(image.colorize_depth(dep, lo, hi),
                                      jax_image.colorize_depth(dep, lo, hi))
    for cols in (None, 2, 5):
        np.testing.assert_array_equal(image.make_grid(post, cols),
                                      jax_image.make_grid(post, cols))


@pytest.mark.parametrize("shape", [(37, 53, 3), (8, 5, 4), (9, 11)])
def test_png_pixels_equal_jax_writer(rng, tmp_path, shape):
    arr = rng.integers(0, 256, size=shape, dtype=np.uint8)
    image.save_image(arr, str(tmp_path / "port.png"))
    jax_image.save_image(arr, str(tmp_path / "jax.png"))
    ours = np.asarray(Image.open(tmp_path / "port.png"))
    np.testing.assert_array_equal(ours, np.asarray(Image.open(
        tmp_path / "jax.png")))
    np.testing.assert_array_equal(ours, arr)
    if arr.ndim == 3 and arr.shape[-1] == 3:
        np.testing.assert_array_equal(image.load_image(
            str(tmp_path / "port.png")), arr)


def test_save_video_needs_a_writer(rng, tmp_path, monkeypatch):
    frames = rng.integers(0, 256, size=(3, 8, 8, 3), dtype=np.uint8)
    path = image.save_video(frames, str(tmp_path / "v.mp4"), fps=10)
    assert path.endswith((".mp4", ".gif")) and os.path.getsize(path) > 0
    for mod in ("imageio", "imageio.v3", "PIL"):
        monkeypatch.setitem(sys.modules, mod, None)
    with pytest.raises(RuntimeError, match="imageio.*PIL"):
        image.save_video(frames, str(tmp_path / "w.mp4"))
    assert not any(p.name.startswith("w.") for p in tmp_path.iterdir())


def test_cli_writes_every_file(tmp_path):
    args = inference.parse_args([
        "--prompt", "a cozy wooden cabin", "--device", "cpu", "--small",
        "--num_steps", "2", "--num_traj_steps", "4", "--render_size", "32",
        "--num_video_frames", "4", "--num_views", "2",
        "--export_dir", str(tmp_path)])
    (rec,) = inference.run(args)
    out = tmp_path / "000_a_cozy_wooden_cabin"
    assert rec["out_dir"] == str(out)
    names = {"gs_renders.png", "mv_images.png", "mv_depths.png",
             "gaussians.ply", "gaussians.splat", "meta.json"}
    files = {p.name for p in out.iterdir()}
    assert names <= files and ({"orbit.mp4", "orbit.gif"} & files)
    assert all(p.stat().st_size > 0 for p in out.iterdir())
    n = rec["n_gaussians"]
    assert gs_io.load_ply(str(out / "gaussians.ply"))[0].shape == (1, n, 3)
    assert (out / "gaussians.splat").stat().st_size == 32 * n
    assert np.asarray(Image.open(out / "gs_renders.png")).shape == (
        32, 66, 3)
    assert set(rec["timings"]) == {"encode_text", "trajectory", "sample",
                                   "decode_2d", "decode_gaussians", "render"}
    # --shard_views: in a process group of one rank the sampler, the decode
    # and render and the video run their sharded paths and write the
    # unsharded run's files
    sharded = tmp_path / "sharded"
    with one_rank_group():
        (srec,) = inference.run(inference.parse_args([
            "--prompt", "a cozy wooden cabin", "--device", "cpu", "--small",
            "--num_steps", "2", "--num_traj_steps", "4", "--render_size",
            "32", "--num_video_frames", "4", "--num_views", "2",
            "--export_dir", str(sharded), "--shard_views"]))
    assert srec["n_gaussians"] == n
    sout = sharded / out.name
    for name in ("gaussians.ply", "gaussians.splat", "gs_renders.png",
                 "mv_images.png"):
        assert (sout / name).read_bytes() == (out / name).read_bytes(), name
    assert inference.parse_args(["--prompt", "x", "--ckpt", "c"]).ckpt == "c"
    # --ref_image is ported (test_torch_image_to_3d runs it): it parses and
    # stands in for a prompt, while no input at all still exits
    ref = inference.parse_args(["--ref_image", "x.png"])
    assert ref.ref_image == "x.png" and inference.prompts_of(ref) == []
    with pytest.raises(SystemExit, match="--ref_image"):
        inference.prompts_of(inference.parse_args([]))


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("flags,refined", [
    (["--refine", "mv_sds", "--refine_iters", "2"], True),
    (["--sampler", "dpmpp_2m", "--guidance_type", "hybrid",
      "--cfg_interval_frac", "0.5"], False),
    (["--use_3d_mode_every_m_steps", "2"], False)])
def test_cli_sampler_modes_and_refine(tmp_path, flags, refined):
    args = inference.parse_args([
        "--prompt", "a cabin", "--device", "cpu", "--small", "--num_steps",
        "2", "--num_traj_steps", "4", "--render_size", "32", "--num_views",
        "2", "--no_video", "--export_dir", str(tmp_path)] + flags)
    (rec,) = inference.run(args)
    out = tmp_path / "000_a_cabin"
    files = {p.name for p in out.iterdir()}
    assert {"gs_renders.png", "mv_images.png", "gaussians.ply"} <= files
    assert ("gs_renders_refined.png" in files) == refined
    assert ("refine" in rec["timings"]) == refined
    if refined:
        assert np.asarray(Image.open(out / "gs_renders_refined.png")).shape \
            == (32, 66, 3)
        assert rec["paths"]["renders_refined"].endswith(
            "gs_renders_refined.png")
