"""Port parity for the tools (``prometheus_torch/tools/``) against the
repo's JAX scripts (``tools/``), run in this process on the same seeded
inputs.

Bit-equal (every output file byte for byte, a PNG pixel for pixel):
``build_metadata``'s
subcommands (on the corpora ``tests/test_build_metadata_ingest.py``,
``test_acquisition_tools.py`` and ``test_legacy_datasets.py`` build, and
COLMAP text and binary models), ``make_synthetic_scenes``,
``generate_captions`` (``--heuristic``, and ``--model_path`` through a
stand-in ``transformers`` module: no VLM is on the disk),
``paper_figures``' three subcommands and ``dataset_gallery``. ``generate_depths``' luminance proxy: the float16
files within 1e-3 (one float16 step near 1 is 4.9e-4).

``stage1_eval``'s per-scene function against the same steps written with
JAX's ``GSDecoderSystem.inference`` and ``metrics.psnr`` / ``ssim``, on the
JAX tool's ``--small`` widths bridged by ``load_jax_params``, a given
disparity and JAX's encoder draw: the renders within 1e-4 absolute (the
compositor's parity bound, PERF.md), PSNR within 1e-3 dB and SSIM within
1e-5. The studies' ``psnr`` and ``fixed_scene_batch`` (given JAX's
cameras and text) against JAX's at 1e-6; each study once, port only, at 2
to 3 steps, with a finite, well-formed JSON. ``parse_trace`` on a
hand-built Chrome trace (known sums) and on a CPU ``profiling.trace``;
``raster_profile`` and ``profile_train_step --small`` at tiny sizes with
every key; ``bench_loader`` and ``test_dataloader`` at 1 scene.
"""
import gzip
import importlib.util
import json
import math
import os
import pickle
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prometheus_torch.tools.test_dataloader as port_test_dataloader
from prometheus_tpu.metrics import psnr as jax_psnr
from prometheus_tpu.metrics import ssim as jax_ssim
from prometheus_tpu.models.gs_decoder import GSDecoderModel as JaxGSDecoder
from prometheus_tpu.systems.gs_decoder_system import \
    GSDecoderSystem as JaxGSSystem
from prometheus_torch.datasets import RealEstate10KDatasetEval
from prometheus_torch.models import GSDecoderModel
from prometheus_torch.systems import GSDecoderSystem
from prometheus_torch.tools import (bench_loader, build_metadata,
                                    dataset_gallery, e2e_quality_study,
                                    generate_captions, generate_depths,
                                    make_synthetic_scenes, paper_figures,
                                    parse_trace, profile_train_step,
                                    raster_profile, refine_width_study,
                                    sampler_quality_study, stage1_eval)
from prometheus_torch.weights import load_jax_params
from test_acquisition_tools import (_scene_model, write_colmap_binary,
                                    write_colmap_text)
from test_build_metadata_ingest import _write_ascii_ply, make_dl3dv_scene
from test_legacy_datasets import (_orbit_pose,
                                  _p3d_viewpoint_from_opencv_w2c, _write_img)
from test_torch_datasets import jpeg_bytes, textured, write_re10k
from test_torch_layers_vae import random_params
from test_torch_sampler_modes import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")


def jax_tool(name: str):
    """The repo's ``tools/<name>.py`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_tool(name: str, argv: list, monkeypatch) -> None:
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", [f"{name}.py"] + argv)
        jax_tool(name).main()


def tree(path) -> dict:
    """``{relative path: bytes}`` of every file under ``path``."""
    out = {}
    for dirpath, _, files in os.walk(path):
        for f in files:
            full = os.path.join(dirpath, f)
            with open(full, "rb") as fp:
                out[os.path.relpath(full, path)] = fp.read()
    return out


def assert_trees_equal(a, b):
    """The same files under ``a`` and ``b``, byte for byte; PNGs pixel for
    pixel (the packages' PNG writers compress differently)."""
    from PIL import Image

    ta, tb = tree(a), tree(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        if k.endswith(".png"):
            ia, ib = (Image.open(os.path.join(d, k)) for d in (a, b))
            assert ia.mode == ib.mode, k
            assert np.array_equal(np.asarray(ia), np.asarray(ib)), k
        else:
            assert ta[k] == tb[k], k


# ---------------------------------------------------------------------------
# build_metadata, make_synthetic_scenes, captions, figures, gallery
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Every raw layout ``build_metadata`` reads, small."""
    d = tmp_path_factory.mktemp("raw")
    for scene in ("a" * 64, "b" * 64):
        make_dl3dv_scene(str(d / "dl3dv"), scene, n=3)
    cams, images = _scene_model(3)
    write_colmap_text(d / "colmap_text", cams, images)
    write_colmap_binary(d / "colmap_bin" / "sparse" / "0", cams, images)
    for cat, scene in (("99", "0a1b"), ("12", "xyz")):
        sdir = d / "mvimgnet" / cat / scene
        write_colmap_binary(sdir / "sparse" / "0", cams, images)
        (sdir / "images").mkdir()
    (d / "mvimgnet" / "99" / "broken").mkdir()
    rng = np.random.default_rng(0)
    urban = {f"kitti360_{s}": [
        {"image_path": f"kitti360/{s}/{i}.jpg",
         "cam2world": np.vstack([_orbit_pose(0.3 * i)[:3], [0, 0, 0, 1]]),
         "cam_K": [[500.0, 0, 320], [0, 510.0, 240], [0, 0, 1]]}
        for i in range(3)] for s in range(2)}
    with open(d / "urbangen.pkl", "wb") as fp:
        pickle.dump(urban, fp)
    frames_meta = []
    for i in range(4):
        c2w = _orbit_pose(0.8 * i, r=3.0)
        r_cv = c2w[:3, :3] @ np.diag([1.0, -1.0, -1.0])
        R, T = _p3d_viewpoint_from_opencv_w2c(r_cv.T, -r_cv.T @ c2w[:3, 3])
        rel = f"apple/seq0/images/frame{i:03d}.jpg"
        _write_img(str(d / "co3d" / rel), i)
        frames_meta.append({
            "sequence_name": "seq0", "frame_number": i,
            "image": {"path": rel, "size": [48, 48]},
            "viewpoint": {"R": R.tolist(), "T": T.tolist(),
                          "focal_length": [2.0, 2.0],
                          "principal_point": [0.1, -0.05]}})
    with gzip.open(d / "co3d" / "apple" / "frame_annotations.jgz",
                   "wt") as fp:
        json.dump(frames_meta, fp)
    _write_ascii_ply(str(d / "co3d" / "apple" / "seq0" / "pointcloud.ply"),
                     rng.normal(0, 0.5, size=(200, 3)))
    for scene in ("car_001", "chair_002"):
        frames = []
        for i in range(3):
            _write_img(str(d / "blender" / scene / f"r_{i}.png"), i)
            frames.append({"file_path": f"r_{i}",
                           "transform_matrix": _orbit_pose(i).tolist()})
        with open(d / "blender" / scene / "transforms.json", "w") as fp:
            json.dump({"camera_angle_x": 0.69, "frames": frames}, fp)
    os.makedirs(d / "t2i" / "captions")
    for i in range(3):
        with open(d / "t2i" / f"sa_{i}.jpg", "wb") as fp:
            fp.write(jpeg_bytes(textured(rng, 20, 28)))
        if i != 1:                               # one without a caption
            (d / "t2i" / "captions" / f"sa_{i}.txt").write_text(
                f"a photo of thing {i}\n")
    with open(d / "journeydb.csv", "w") as fp:
        fp.write("path,caption\n")
        for i in range(5):
            fp.write(f"a/b/imgs/{i:03d}.jpg,prompt number {i}\n")
    write_re10k(str(d / "re10k"), rng, keys=("aaa", "bbb"), n=3)
    return d


# subcommand -> (argv with {raw} and {side} placeholders, inputs copied
# into the side's directory first: the subcommands that write beside them)
METADATA = {
    "scan-scenes": (["--root", "{raw}/dl3dv", "--out", "{side}/a.pkl"], ()),
    "re10k-index": (["--root", "{side}/re10k"], ("re10k",)),
    "colmap-text": (["--root", "{raw}/colmap_text", "--out", "{side}/a.pkl"],
                    ()),
    "colmap-binary": (["--root", "{raw}/colmap_bin", "--out",
                       "{side}/a.pkl"], ()),
    "dl3dv-raw": (["--root", "{raw}/dl3dv", "--out", "{side}/a.pkl",
                   "--require_caption"], ()),
    "urbangen-pkl": (["--annotation", "{raw}/urbangen.pkl", "--out",
                      "{side}/a.pkl"], ()),
    "co3d": (["--root", "{raw}/co3d", "--out", "{side}/a.pkl"], ()),
    "co3d-depth-obb": (["--root", "{raw}/co3d", "--annotation",
                        "{side}/co3d.pkl", "--out", "{side}/depth",
                        "--depth_size", "24"], ("co3d.pkl",)),
    "co3d-depth-points": (["--root", "{raw}/co3d", "--annotation",
                           "{side}/co3d.pkl", "--out", "{side}/depth",
                           "--mode", "points", "--depth_size", "24"],
                          ("co3d.pkl",)),
    "blender": (["--root", "{raw}/blender", "--out", "{side}/a.pkl",
                 "--prompt_suffix", "white background"], ()),
    "t2i-captions": (["--root", "{raw}/t2i", "--out", "{side}/a.json"], ()),
    "mvimgnet": (["--root", "{raw}/mvimgnet", "--out", "{side}/a.pkl"], ()),
    "journeydb-csv": (["--raw_csv", "{raw}/journeydb.csv", "--out",
                       "{side}/jdb", "--shard_size", "2"], ()),
}


@pytest.mark.parametrize("case", list(METADATA))
def test_build_metadata_bit_equal(case, raw, tmp_path, monkeypatch):
    argv, copies = METADATA[case]
    if case.startswith("co3d-depth"):          # its input: co3d's output
        build_metadata.main(["co3d", "--root", str(raw / "co3d"), "--out",
                             str(raw / "co3d.pkl")])
    cmd = case.split("-")[0] if case.startswith(("colmap", "co3d-depth")) \
        else case
    cmd = "co3d-depth" if case.startswith("co3d-depth") else cmd
    sides = {}
    for side in ("jax", "port"):
        sdir = tmp_path / side
        sdir.mkdir()
        for c in copies:
            src = raw / c
            (shutil.copytree if src.is_dir() else shutil.copy)(src, sdir / c)
        args = [cmd] + [a.format(raw=raw, side=sdir) for a in argv]
        if side == "jax":
            run_jax_tool("build_metadata", args, monkeypatch)
        else:
            build_metadata.main(args)
        sides[side] = sdir
    assert tree(sides["port"])
    assert_trees_equal(sides["jax"], sides["port"])


def test_make_synthetic_scenes_bit_equal(tmp_path, monkeypatch):
    argv = ["--scenes", "2", "--frames", "3", "--height", "36", "--width",
            "48", "--seed", "3"]
    run_jax_tool("make_synthetic_scenes",
                 argv + ["--out", str(tmp_path / "jax")], monkeypatch)
    make_synthetic_scenes.main(argv + ["--out", str(tmp_path / "port")])
    assert len(tree(tmp_path / "port")) == 7
    assert_trees_equal(tmp_path / "jax", tmp_path / "port")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """A DL3DV-layout corpus of ``bench_loader.build_dataset`` (2 scenes
    of 6 frames at 90x120), the one ``tests/test_dataset_gallery.py``
    uses."""
    root = tmp_path_factory.mktemp("scenes")
    bench_loader.build_dataset(str(root), 2, 6, (90, 120),
                               np.random.default_rng(0))
    return root


def test_generate_captions_heuristic_bit_equal(scenes, tmp_path,
                                               monkeypatch):
    argv = ["--root", str(scenes), "--annotation",
            str(scenes / "annotation.pkl"), "--heuristic"]
    run_jax_tool("generate_captions", argv + ["--out", str(tmp_path / "j")],
                 monkeypatch)
    generate_captions.main(argv + ["--out", str(tmp_path / "p")])
    assert sorted(tree(tmp_path / "p")) == ["scene_0.txt", "scene_1.txt"]
    assert_trees_equal(tmp_path / "j", tmp_path / "p")
    with pytest.raises(SystemExit, match="--model_path or --heuristic"):
        generate_captions.main(argv[:-1] + ["--out", str(tmp_path / "x")])


def fake_transformers():
    """A stand-in ``transformers`` module: a "VLM" that captions an image
    with its size and mean colour, and records what it was loaded with."""
    import types

    loaded = []

    class Processor:
        def __call__(self, images, text, return_tensors):
            return {"pixels": np.asarray(images), "text": text}

        def decode(self, out, skip_special_tokens):
            return f"  a scene of mean {out[0]:.3f} ({out[1]}) "

    class Model:
        def generate(self, pixels, text, max_new_tokens):
            return [(float(pixels.mean()), f"{pixels.shape} {text}")]

    def loader(obj):
        def from_pretrained(path, local_files_only):
            loaded.append((path, local_files_only))
            return obj
        return types.SimpleNamespace(from_pretrained=from_pretrained)

    mod = types.ModuleType("transformers")
    mod.AutoProcessor, mod.AutoModelForCausalLM = (loader(Processor()),
                                                   loader(Model()))
    return mod, loaded


def test_generate_captions_model_path_bit_equal(scenes, tmp_path,
                                                monkeypatch):
    """``--model_path`` through a stand-in VLM (no VLM is on the disk):
    the same frames, prompt and files as the JAX script, weights read
    with ``local_files_only``."""
    mod, loaded = fake_transformers()
    monkeypatch.setitem(sys.modules, "transformers", mod)
    argv = ["--root", str(scenes), "--annotation",
            str(scenes / "annotation.pkl"), "--model_path", "vlm_dir",
            "--frames_per_scene", "2"]
    run_jax_tool("generate_captions", argv + ["--out", str(tmp_path / "j")],
                 monkeypatch)
    generate_captions.main(argv + ["--out", str(tmp_path / "p")])
    assert loaded == [("vlm_dir", True)] * 4
    assert_trees_equal(tmp_path / "j", tmp_path / "p")
    lines = (tmp_path / "p" / "scene_0.txt").read_text().splitlines()
    assert len(lines) == 2 and lines[0].startswith("a scene of mean")


def test_dataset_gallery_bit_equal(scenes, tmp_path, monkeypatch):
    argv = ["--root", str(scenes), "--annotation",
            str(scenes / "annotation.pkl"), "--num_scenes", "2", "--views",
            "3", "--img_size", "64"]
    run_jax_tool("dataset_gallery", argv + ["--out", str(tmp_path / "j")],
                 monkeypatch)
    dataset_gallery.main(argv + ["--out", str(tmp_path / "p")])
    assert {"index.html", "000_frames.png", "001_traj.png"} <= set(
        tree(tmp_path / "p"))
    assert_trees_equal(tmp_path / "j", tmp_path / "p")


def views(d, n, seed, h=24, w=32):
    from PIL import Image

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(d, f"view_{i:02d}.png"))


@pytest.mark.parametrize("cmd", ["figure", "teaser", "convert"])
def test_paper_figures_bit_equal(cmd, tmp_path, monkeypatch):
    from PIL import Image

    src = tmp_path / "src"
    if cmd == "figure":
        views(src / "inputs", 3, 0)
        views(src / "renders", 3, 1)
        os.makedirs(src / "depth")
        np.save(src / "depth" / "000000.npy",
                np.random.default_rng(2).random((24, 32)))
        args = ["--scene_dir", str(src)]
    elif cmd == "teaser":
        for p in range(3):
            views(src / f"prompt_{p}", 5, p)
        args = ["--gallery_dir", str(src), "--max_prompts", "2",
                "--views_per_prompt", "3"]
    else:
        for i, sub in enumerate(("", "a/b")):
            os.makedirs(src / sub, exist_ok=True)
            Image.fromarray(np.full((8, 8, 3), 40 * i + 10, np.uint8)).save(
                src / sub / f"img{i}.webp")
        args = ["--src", str(src)]
    for side in ("jax", "port"):
        out = ["--dst", str(tmp_path / side)] if cmd == "convert" else \
            ["--out", str(tmp_path / side / "fig.png")]
        os.makedirs(tmp_path / side, exist_ok=True)
        if side == "jax":
            run_jax_tool("paper_figures", [cmd] + args + out, monkeypatch)
        else:
            paper_figures.main([cmd] + args + out)
    assert tree(tmp_path / "port")
    assert_trees_equal(tmp_path / "jax", tmp_path / "port")


def test_generate_depths_luminance_matches_jax(scenes, tmp_path,
                                               monkeypatch):
    ann = tmp_path / "ann.pkl"
    shutil.copy(scenes / "annotation.pkl", ann)
    argv = ["--root", str(scenes), "--annotation", str(ann), "--size", "28",
            "--batch", "4", "--max_scenes", "1"]
    run_jax_tool("generate_depths", argv + ["--out", str(tmp_path / "j")],
                 monkeypatch)
    jax_ann = pickle.load(open(str(ann) + ".depth.pkl", "rb"))
    generate_depths.main(argv + ["--out", str(tmp_path / "p"), "--device",
                                 "cpu"])
    assert pickle.load(open(str(ann) + ".depth.pkl", "rb")) == jax_ann
    files = sorted(tree(tmp_path / "p"))
    assert files == sorted(tree(tmp_path / "j")) and len(files) == 6
    for f in files:
        a, b = np.load(tmp_path / "p" / f), np.load(tmp_path / "j" / f)
        assert a.dtype == np.float16 and a.shape == (28, 28)
        np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32),
                                   rtol=0, atol=1e-3)


def test_generate_depths_with_da2_weights(scenes, tmp_path):
    """The DA2 path through the port's HF loader, at 28^2 (2 x 2 patches)."""
    sys.path.insert(0, ROOT)
    from chip_smoke import write_da2_weights

    weights = tmp_path / "da2.pt"
    write_da2_weights(weights, seed=0)
    ann = tmp_path / "ann.pkl"
    shutil.copy(scenes / "annotation.pkl", ann)
    out = generate_depths.main([
        "--root", str(scenes), "--annotation", str(ann), "--out",
        str(tmp_path / "d"), "--weights", str(weights), "--size", "28",
        "--batch", "4", "--max_scenes", "1", "--device", "cpu"])
    assert out["frames"] == 6
    d = np.load(tmp_path / "d" / "scene_0" / "frame_000.npy")
    assert d.shape == (28, 28) and d.min() == 0 and d.max() == 1


# ---------------------------------------------------------------------------
# data loading tools
# ---------------------------------------------------------------------------

def test_bench_loader_one_scene():
    res = bench_loader.main([
        "--scenes", "1", "--frames", "4", "--hw", "48", "64", "--img_size",
        "32", "--views", "2", "--batch", "1", "--workers", "1", "--seconds",
        "0.4", "--repeats", "1"])
    for path in ("native", "python"):
        for kind in ("", "_threads"):
            assert res[f"images_per_s_{path}{kind}"] > 0
            assert len(res[f"images_per_s_{path}{kind}_runs"]) == 1
    assert res["jpeg_native"] is True
    assert math.isfinite(res["native_speedup"])
    assert os.environ.get("PROMETHEUS_NATIVE") is None


def test_test_dataloader_one_scene(scenes, tmp_path, capsys):
    rate = port_test_dataloader.main([
        "--root", str(scenes), "--annotation", str(scenes / "annotation.pkl"),
        "--batch_size", "1", "--num_batches", "2", "--img_size", "32",
        "--out", str(tmp_path)])
    assert rate > 0 and (tmp_path / "batch0.png").stat().st_size > 0
    out = capsys.readouterr().out
    assert "batch 0: images torch.Size([1, 4, 3, 32, 32])" in out


# ---------------------------------------------------------------------------
# stage1_eval
# ---------------------------------------------------------------------------

def test_stage1_eval_scene_matches_jax(tmp_path):
    rs = 32
    data = tmp_path / "re10k"
    write_re10k(str(data), np.random.default_rng(5), keys=("aaa",), n=4)
    index = tmp_path / "index.json"
    index.write_text(json.dumps({"aaa": {"context": [0, 2],
                                         "target": [1, 3]}}))
    ds = RealEstate10KDatasetEval(str(data), str(index), img_size=rs,
                                  scene_scale_threshold=0.0)
    item = ds[0]
    nc = item["num_context"]
    rng = np.random.default_rng(6)
    jmod = JaxGSDecoder(dtype=jnp.float32, **stage1_eval.SMALL_WIDTHS)
    hw = rs // 4
    variables = random_params(jmod, rng, jnp.zeros((1, 1, 3, rs, rs)),
                              jnp.zeros((1, 1, 14, hw, hw)),
                              method=JaxGSDecoder.init_everything)
    disp = rng.uniform(0.05, 1.0, size=(1, nc, 1, rs, rs)).astype(np.float32)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                         (nc, 4, hw, hw))).copy()

    jsys = JaxGSSystem(model=jmod, render_size=rs)
    images = jnp.asarray(item["images_mv"])[None]
    cams = jnp.asarray(item["cameras_mv"])[None]
    with jax.default_matmul_precision("float32"):
        ref = jax.jit(lambda v: jsys.inference(
            v, images[:, :nc], jnp.asarray(disp), cams[:, :nc], cams[:, nc:],
            render_size=rs))(variables)
    ref_pred = np.asarray(ref["images_nv_pred"][0])
    gt = np.asarray(item["images_mv"][nc:])
    ref_psnr, ref_ssim = [], []
    for v in range(ref_pred.shape[0]):
        p01 = (ref_pred[v].transpose(1, 2, 0) + 1) / 2
        g01 = (gt[v].transpose(1, 2, 0) + 1) / 2
        ref_psnr.append(jax_psnr(p01, g01))
        ref_ssim.append(jax_ssim(p01, g01))

    system = stage1_eval.build_system(True, rs, torch.device("cpu"))
    assert isinstance(system, GSDecoderSystem)
    assert isinstance(system.model, GSDecoderModel)
    assert load_jax_params(system.model, variables) == []
    entry, out = stage1_eval.evaluate_scene(
        system, lambda x: torch.from_numpy(disp), item, str(tmp_path / "o"),
        rs, noise=torch.from_numpy(noise).reshape(1, nc, 4, hw, hw))
    pred = out["images_nv_pred"][0].numpy()
    assert np.abs(pred - ref_pred).max() <= 1e-4
    assert entry["scene"] == "aaa"
    assert abs(entry["psnr"] - float(np.mean(ref_psnr))) <= 1e-3
    assert abs(entry["ssim"] - float(np.mean(ref_ssim))) <= 1e-5
    assert sorted(tree(tmp_path / "o" / "aaa")) == sorted(
        f"{k}_{v:02d}.png" for k in ("pred", "gt", "error", "depth")
        for v in range(2))


def test_stage1_eval_cli_and_checkpoints(tmp_path):
    """The CLI end to end on the CPU at 32^2 (the random DA2 teacher sees
    2 x 2 patches of 14); ``--ckpt`` of a release bundle and of a
    ``step_*`` checkpoint (its EMA laid over the trained weights)."""
    from prometheus_torch.checkpoint import save_checkpoint, write_bundle
    from prometheus_torch.parallel import init_train_state, make_optimizer

    data = tmp_path / "re10k"
    write_re10k(str(data), np.random.default_rng(5), keys=("aaa", "bbb"),
                n=3)
    index = tmp_path / "index.json"
    index.write_text(json.dumps({"aaa": {"context": [0, 2], "target": [1]},
                                 "bbb": {"context": [0, 1], "target": [2]}}))
    res = stage1_eval.main([
        "--data_root", str(data), "--eval_index", str(index),
        "--render_size", "32", "--device", "cpu", "--small", "--out",
        str(tmp_path / "a")])
    assert res["num_scenes"] == 2 and finite_json(res)
    assert json.load(open(tmp_path / "a" / "metrics.json")) == res

    cpu = torch.device("cpu")
    model = stage1_eval.build_system(True, 32, cpu, seed=4).model
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    write_bundle(str(tmp_path / "bundle"),
                 {"mvldm": {}, "traj": {}, "gsdecoder": sd},
                 {"gsdecoder": dict(stage1_eval.SMALL_WIDTHS)})
    got = stage1_eval.build_system(False, 32, cpu,
                                   str(tmp_path / "bundle")).model
    assert all(torch.equal(v, sd[k]) for k, v in got.state_dict().items())

    state = init_train_state(model, make_optimizer(model.parameters()))
    with torch.no_grad():
        for v in state.ema_params.values():
            v.add_(1.0)
    save_checkpoint(str(tmp_path / "ckpt"), state, step=3)
    got = stage1_eval.build_system(False, 32, cpu,
                                   str(tmp_path / "ckpt")).model
    for k, v in got.named_parameters():
        assert torch.equal(v, sd[k] + 1.0), k


# ---------------------------------------------------------------------------
# the studies
# ---------------------------------------------------------------------------

def test_study_helpers_match_jax():
    jstudy = jax_tool("sampler_quality_study")
    ids = [0, 3]
    ref = jstudy.fixed_scene_batch(jax.random.PRNGKey(0), ids, n_views=3,
                                   img=16)
    out = sampler_quality_study.fixed_scene_batch(
        ids, n_views=3, img=16, cameras=np.asarray(ref["cameras_mv"]),
        text=np.asarray(ref["text_emb"]))
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 3, 8, 8)), rng.normal(size=(2, 3, 8, 8))
    assert sampler_quality_study.psnr(a, b) == jstudy.psnr(a, b)
    assert sampler_quality_study.psnr(b, b) == jstudy.psnr(b, b) == math.inf
    # the port draws its own cameras and text when none are given
    own = sampler_quality_study.fixed_scene_batch(ids, n_views=3, img=16)
    assert own["cameras_mv"].shape == (2, 3, 18)
    assert own["text_emb"].shape == (2, 77, 64)
    np.testing.assert_array_equal(own["images_mv"].numpy(),
                                  out["images_mv"].numpy())


def finite_json(obj) -> bool:
    if isinstance(obj, dict):
        return all(finite_json(v) for v in obj.values())
    if isinstance(obj, list):
        return all(finite_json(v) for v in obj)
    if isinstance(obj, float):
        return math.isfinite(obj)
    return True


def test_sampler_quality_study_runs(tmp_path, monkeypatch):
    monkeypatch.setattr(sampler_quality_study, "CANDIDATES",
                        (("euler", 2), ("dpmpp_2m", 2)))
    out = tmp_path / "s.json"
    res = sampler_quality_study.main([
        "--train_steps", "2", "--scenes", "2", "--views", "2", "--img", "16",
        "--ref_steps", "3", "--device", "cpu", "--out", str(out)])
    assert json.load(open(out)) == res and finite_json(res)
    assert [r["sampler"] for r in res["samplers"]] == ["euler", "dpmpp_2m"]
    assert len(res["loss_curve"]) == 2 and res["ref_sampler"] == "euler@3"
    for r in res["samplers"]:
        assert r["latent_psnr_db"] > 0 and r["image_psnr_db"] > 0


def test_e2e_quality_study_runs(tmp_path, monkeypatch):
    monkeypatch.setattr(e2e_quality_study, "SAMPLERS",
                        (("euler", 2), ("dpmpp_2m", 2)))
    out = tmp_path / "e.json"
    res = e2e_quality_study.main([
        "--train_steps", "2", "--gs_train_steps", "2", "--scenes", "1",
        "--views", "2", "--img", "16", "--device", "cpu", "--out", str(out)])
    assert json.load(open(out)) == res and finite_json(res)
    assert set(res) == {"scenes", "views", "img", "guidance_scale", "stage1",
                        "stage2", "oracle_stage2_render_psnr_db",
                        "oracle_stage2_all_views_db", "e2e"}
    assert [len(r["per_scene"]) for r in res["e2e"]] == [1, 1]


def test_refine_width_study_runs(tmp_path):
    out = tmp_path / "r.json"
    res = refine_width_study.main([
        "--widths", "0.1", "--iters", "2", "--gaussians", "500", "--views",
        "2", "--img_size", "64", "--device", "cpu", "--out", str(out)])
    assert json.load(open(out)) == res and finite_json(res)
    (r,) = res["widths"]
    assert r["finite"] and len(r["per_iter_s"]) == 2 and len(r["losses"]) == 2
    assert r["model_channels"] == 32 and not res["flagship_ok"]


# ---------------------------------------------------------------------------
# the profiling tools
# ---------------------------------------------------------------------------

def test_parse_trace_known_sums(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "gemm", "pid": 0, "tid": 7,
         "ts": 0.0, "dur": 300.0},
        {"ph": "X", "cat": "kernel", "name": "gemm", "pid": 0, "tid": 7,
         "ts": 500.0, "dur": 200.0},
        {"ph": "X", "cat": "kernel", "name": "softmax", "pid": 0, "tid": 7,
         "ts": 800.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "copy_kernel", "pid": 0,
         "tid": 9, "ts": 10.0, "dur": 50.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 11,
         "tid": 11, "ts": 0.0, "dur": 1000.0},
        {"ph": "i", "cat": "marker", "name": "ignored", "pid": 0, "tid": 7,
         "ts": 5.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = parse_trace.summarize(str(path))
    s7 = out["device 0 stream 7"]["kernel"]
    assert s7["events"] == 3 and s7["busy_ms"] == 0.6
    assert s7["span_ms"] == 0.9
    assert s7["top"] == [["gemm", 0.5, 2], ["softmax", 0.1, 1]]
    assert out["device 0 stream 9"]["kernel"]["top"] == [
        ["copy_kernel", 0.05, 1]]
    assert out["host 11 thread 11"]["cpu_op"]["busy_ms"] == 1.0
    dev = parse_trace.summarize(str(path), top=1, plane="stream 7",
                                line="kernel")
    assert list(dev) == ["device 0 stream 7"]
    assert dev["device 0 stream 7"]["kernel"]["top"] == [["gemm", 0.5, 2]]
    assert list(parse_trace.main([str(tmp_path)])) == [str(path)]


def test_parse_trace_gaps_by_innermost_span(tmp_path):
    """Device busy 0-100, 150-300 (two streams overlapping), 400-450 and
    460-500 us; the gaps 100-150 (middle 125: inside ``traj.step`` inside
    ``t2s.batch``), 300-400 (350: inside ``gc`` inside ``traj.step``) and
    450-460 (455: after every span)."""
    def x(cat, name, ts, dur, pid=0, tid=7):
        return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
                "ts": ts, "dur": dur}

    events = [
        x("kernel", "gemm", 0.0, 100.0), x("kernel", "gemm", 150.0, 100.0),
        x("gpu_memcpy", "Memcpy DtoH", 200.0, 100.0, tid=9),
        x("kernel", "softmax", 400.0, 50.0), x("gpu_memset", "set", 460.0,
                                               40.0),
        x("gpu_user_annotation", "prometheus.t2s.batch", 0.0, 500.0),
        x("user_annotation", "prometheus.t2s.batch", 0.0, 440.0, 11, 11),
        x("user_annotation", "prometheus.traj.step", 90.0, 300.0, 11, 11),
        x("user_annotation", "prometheus.gc", 320.0, 50.0, 11, 11),
        x("cpu_op", "aten::mm", 110.0, 30.0, 11, 11),
        x("user_annotation", "other_range", 340.0, 5.0, 11, 11),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    g = parse_trace.idle_gaps(str(path))
    assert g["busy_ms"] == pytest.approx(0.34)
    assert g["window_ms"] == pytest.approx(0.5)
    assert g["idle_ms"] == pytest.approx(0.16) and g["gaps"] == 3
    assert g["by_span"] == [["prometheus.gc", pytest.approx(0.1), 1],
                            ["prometheus.traj.step", pytest.approx(0.05), 1],
                            ["(no span)", pytest.approx(0.01), 1]]
    assert [n for n, _ in g["longest"]] == [
        "prometheus.gc", "prometheus.traj.step", "(no span)"]
    assert parse_trace.main([str(path), "--gaps"]) == {str(path): g}


def test_profile_train_step_and_its_trace(tmp_path):
    res = profile_train_step.profile(
        small=True, iters=1, sections=profile_train_step.SECTIONS,
        device="cpu", trace=str(tmp_path / "trace"), views=2)
    keys = {"unet_fwd_ms", "unet_fwd_bwd_checkpoint_on_ms",
            "unet_fwd_bwd_checkpoint_off_ms", "vae_encode_16imgs_ms",
            "loss_fwd_ms", "loss_fwd_bwd_ms", "full_step_ms",
            "synth_batch_ms", "loop_step_ms"}
    assert keys <= set(res) and set(res["spread"]) == keys
    assert all(0 < res["spread"][k][0] <= res[k] <= res["spread"][k][1]
               for k in keys)
    assert res["views"] == 2 and res["trace"].endswith("trace.json")
    summary = parse_trace.summarize(res["trace"], top=5, line="cpu_op")
    (host,) = [p for p in summary if p.startswith("host")]
    ops = summary[host]["cpu_op"]
    assert ops["events"] > 100 and len(ops["top"]) == 5
    assert ops["top"][0][1] >= ops["top"][-1][1] > 0


def test_raster_profile_keys(tmp_path):
    """Every timing key of the JAX tool maps onto a stage the port times:
    the JAX tool's five slot modes onto the port's one slot layout.
    ``--fast`` (the JAX tool's "scanu only") is accepted and times the
    same stages."""
    jax_slot = {f"expand_{m}_ms" for m in ("scanu", "fscatter", "addcumsum",
                                          "scan", "bsearch")} | {
        "sub_prefix_ms", "sub_decode_scanu_ms", "sub_decode_scan_ms",
        "sub_gather_cull_ms", "binsort_scanu_ms", "binsort_fscatter_ms",
        "e2e_pallas_ms", "e2e_pallas_fscatter_ms"}
    slot = {"expand_ms", "sub_prefix_ms", "sub_decode_ms",
            "sub_gather_cull_ms", "binsort_slots_ms", "e2e_slots_ms"}
    csort = {"project_ms", "bin_keys_ms", "sort_ms", "binsort_ms",
             "segments_gather_ms", "kernel_ms", "compositor_ms", "e2e_ms",
             "e2e_plain_ms"}
    jax_tool = {"project_ms", "sort_ms", "segments_gather_ms", "kernel_ms",
                "binsort_csort_ms", "e2e_pallas_csort_ms", "e2e_xla_ms"}
    assert set(raster_profile.JAX_KEYS) == jax_tool | jax_slot
    assert {raster_profile.JAX_KEYS[k] for k in jax_slot} == slot
    assert not hasattr(raster_profile, "JAX_KEYS_WITHOUT_COUNTERPART")
    out = tmp_path / "r.json"
    res = raster_profile.main(["--n", "1500", "--size", "64", "--reps", "1",
                               "--device", "cpu", "--out", str(out)])
    assert json.load(open(out)) == res
    t = res["timings_ms"]
    assert set(t) == csort | slot
    assert all(v > 0 for v in t.values())
    assert set(raster_profile.JAX_KEYS.values()) <= set(t)
    assert 0 < res["instances_kept"] <= res["candidates_live"] <= \
        res["candidates"]
    assert 0 < res["slots_live"] <= res["s_max"] == 6 * 1500
    assert res["decode_winner"] == min(
        ("csort", "slots"), key=lambda m: t["binsort_ms" if m == "csort"
                                            else "binsort_slots_ms"])
    fast = raster_profile.main(["--n", "1500", "--size", "64", "--reps",
                                "1", "--device", "cpu", "--fast", "--out",
                                str(out)])
    assert set(fast["timings_ms"]) == csort | slot
    assert fast["slots_live"] == res["slots_live"]
