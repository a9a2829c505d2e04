"""Port parity for the data pipeline (``prometheus_torch/datasets/``), the
config composition (``config.py``), the camera helpers of the datasets and
the snapshot utilities, on small corpora written here with numpy and PIL.

Both packages run with ``PROMETHEUS_NATIVE=0`` (the process's variable;
the port's loader hands it to its workers), so both take the same PIL +
numpy path; the native data plane is held in ``test_torch_native.py``. Tolerances:
- the decode / crop / resize / normalise transform and its intrinsics, the
  file readers, the augmentations, the snapshot files: bit-equal;
- dataset items (DL3DV, MVImgNet, UrbanGen, Objaverse, RE10K chunks, T2I,
  the mixers and every dataset group of the configs), index by index, and
  the loader's batches: images and cameras within 1e-6 absolute, texts and
  names equal;
- the tensor camera helpers against JAX at 1e-6.
"""
import io
import json
import os
import pickle
import tarfile
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import prometheus_tpu.config as jconfig
import prometheus_tpu.datasets as jds
from prometheus_tpu.datasets import builder as jbuilder
from prometheus_tpu.datasets import transforms as jtf
from prometheus_tpu.utils import cameras as jcam
from prometheus_tpu.utils import image as jimage
from prometheus_tpu.utils import visualization as jvis
import prometheus_torch.datasets as tds
from prometheus_torch import config as tconfig
from prometheus_torch.datasets import builder as tbuilder
from prometheus_torch.datasets import transforms as ttf
from prometheus_torch.utils import cameras as tcam
from prometheus_torch.utils import image as timage
from prometheus_torch.utils import visualization as tvis
from prometheus_torch.utils.nan_guard import assert_finite, check_finite

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIGS = os.path.join(ROOT, "prometheus_tpu", "configs")
TORCH_CONFIGS = os.path.join(ROOT, "prometheus_torch", "configs")
EXPERIMENTS = sorted(f[:-5] for f in os.listdir(
    os.path.join(JAX_CONFIGS, "experiment")))
DATASET_GROUPS = sorted(f[:-5] for f in os.listdir(
    os.path.join(JAX_CONFIGS, "dataset")))


@pytest.fixture(autouse=True)
def python_data_plane(monkeypatch):
    monkeypatch.setenv("PROMETHEUS_NATIVE", "0")


# ---------------------------------------------------------------------------
# corpora (numpy + PIL)
# ---------------------------------------------------------------------------

def orbit_c2w(n, radius=2.0, arc=np.pi, height=0.2):
    """OpenGL look-at-origin poses (n, 3, 4) on an arc of an orbit."""
    az = np.linspace(0.0, arc, n)
    eye = np.stack([radius * np.cos(az), height * np.ones(n),
                    radius * np.sin(az)], -1)
    z = eye / np.linalg.norm(eye, axis=-1, keepdims=True)
    x = np.cross(np.broadcast_to([0.0, 1.0, 0.0], eye.shape), z)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    y = np.cross(z, x)
    return np.stack([x, y, z, eye], -1)


def textured(rng, h, w):
    """A smooth pattern with noise (uint8 HWC): JPEG keeps its structure."""
    yy, xx = np.mgrid[0:h, 0:w]
    ph = rng.uniform(0, 6, 3)
    img = np.stack([127 + 80 * np.sin(yy / (5 + 3 * c) + ph[c])
                    * np.cos(xx / (7 + 2 * c)) for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(
        np.uint8)


def jpeg_bytes(arr, quality=90):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def write_scenes(root, rng, n_scenes=3, n_frames=10, hw=(24, 32),
                 opencv=False, layout="annotation", extra=None,
                 intrinsics=(30.0, 30.0, 16.0, 12.0)):
    """Scenes of JPEG frames on an orbit. ``layout='annotation'`` writes
    ``root/annotation.pkl``; ``'meta'`` writes ``root/<scene>/meta.json``.
    Returns the annotation path (or None)."""
    os.makedirs(root, exist_ok=True)
    ann = {}
    for s in range(n_scenes):
        scene = f"scene_{s:03d}"
        os.makedirs(os.path.join(root, scene), exist_ok=True)
        frames = []
        for i in range(n_frames):
            f = f"{scene}/{i:04d}.jpg"
            with open(os.path.join(root, f), "wb") as fp:
                fp.write(jpeg_bytes(textured(rng, *hw)))
            frames.append(f)
        poses = orbit_c2w(n_frames, radius=1.5 + 0.5 * s)
        if opencv:
            poses = poses * np.asarray([1.0, -1.0, -1.0, 1.0])
        meta = {"frames": frames, "poses": poses.tolist(),
                "intrinsics": list(intrinsics),
                "captions": [f"scene {s} caption {k}" for k in range(3)],
                **((extra or {}).get(s, {}))}
        if layout == "meta":
            with open(os.path.join(root, scene, "meta.json"), "w") as fp:
                json.dump(meta, fp)
        ann[scene] = meta
    if layout == "meta":
        return None
    path = os.path.join(root, "annotation.pkl")
    with open(path, "wb") as fp:
        pickle.dump(ann, fp)
    return path


def write_re10k(root, rng, keys=("aaa", "bbb", "ccc"), n=8, hw=(24, 40)):
    """pixelSplat chunks: JPEG byte tensors and ``[fx/W, fy/H, cx/W, cy/H,
    0, 0, w2c(12)]`` OpenCV camera rows, over two chunk files."""
    os.makedirs(root, exist_ok=True)
    index, chunks = {}, {}
    for j, key in enumerate(keys):
        poses_cv = orbit_c2w(n, radius=2.0 + j) * np.asarray(
            [1.0, -1.0, -1.0, 1.0])
        cams = []
        for i in range(n):
            w2c = np.linalg.inv(np.vstack([poses_cv[i], [[0, 0, 0, 1]]]))[:3]
            cams.append(np.concatenate([[0.9, 1.2, 0.5, 0.5, 0.0, 0.0],
                                        w2c.reshape(-1)]))
        images = [torch.frombuffer(bytearray(jpeg_bytes(textured(rng, *hw))),
                                   dtype=torch.uint8) for _ in range(n)]
        chunk = f"{j % 2:06d}.torch"
        chunks.setdefault(chunk, []).append(
            {"key": key, "images": images,
             "cameras": torch.tensor(np.stack(cams), dtype=torch.float32)})
        index[key] = chunk
    for chunk, scenes in chunks.items():
        torch.save(scenes, os.path.join(root, chunk))
    with open(os.path.join(root, "index.json"), "w") as fp:
        json.dump(index, fp)


def write_t2i(root, rng, n=7, hw=(28, 20)):
    os.makedirs(root, exist_ok=True)
    items = []
    for i in range(n):
        f = f"img_{i}.jpg"
        with open(os.path.join(root, f), "wb") as fp:
            fp.write(jpeg_bytes(textured(rng, *hw)))
        items.append({"file": f, "caption": f"The image shows  thing {i}"})
    with open(os.path.join(root, "annotations.json"), "w") as fp:
        json.dump(items, fp)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Every dataset kind in one tree: ``data_root`` in the configs'
    layout (meta.json scenes) and annotation-file scenes beside it."""
    rng = np.random.default_rng(0)
    base = tmp_path_factory.mktemp("corpus")
    data = base / "data"
    write_scenes(str(data / "dl3dv"), rng, layout="meta")
    write_scenes(str(data / "mvimgnet"), rng, opencv=True, layout="meta")
    write_scenes(str(data / "urbangen"), rng, opencv=True, layout="meta",
                 extra={0: {"subdataset": "kitti360"}})
    write_scenes(str(data / "objaverse"), rng, opencv=True, layout="meta",
                 n_frames=12)
    for sub in ("re10k/train", "re10k/test", "acid/train"):
        write_re10k(str(data / sub), rng)
    write_t2i(str(data / "sam1b"), rng)
    ann = write_scenes(str(base / "dl3dv_ann"), rng, n_scenes=4,
                       n_frames=6)
    with open(base / "captions.csv", "w") as fp:
        fp.write("scene_001,a csv caption\n")
    return {"data": str(data), "base": str(base), "ann": ann}


def assert_items_equal(a, b, atol=1e-6):
    assert set(a) == set(b)
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor):
            x = x.numpy()
        if isinstance(x, np.ndarray):
            y = np.asarray(y)
            assert x.shape == y.shape and x.dtype == y.dtype, k
            np.testing.assert_allclose(x, y, rtol=0, atol=atol, err_msg=k)
        else:
            assert x == y, k


# ---------------------------------------------------------------------------
# transforms, readers, camera helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["jpeg_draft", "jpeg_small", "png",
                                  "normalized"])
def test_decode_crop_resize_normalize_is_bit_equal(kind):
    rng = np.random.default_rng(3)
    hw = (720, 960) if kind == "jpeg_draft" else (36, 52)
    arr = textured(rng, *hw)
    if kind == "png":
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        data = buf.getvalue()
    else:
        data = jpeg_bytes(arr)
    normalized = kind == "normalized"
    intr = (np.asarray([0.9, 1.2, 0.5, 0.45], np.float32) if normalized
            else np.asarray([700.0, 690.0, 480.0, 355.0], np.float32))
    ref, ref_intr = jtf.decode_crop_resize_normalize(data, 32, intr,
                                                     normalized=normalized)
    out, out_intr = ttf.decode_crop_resize_normalize(data, 32, intr,
                                                     normalized=normalized)
    assert out.shape == (3, 32, 32) and out.dtype == np.float32
    assert np.array_equal(out, ref) and np.array_equal(out_intr, ref_intr)
    if kind == "jpeg_draft":      # the DCT downscale really ran
        _, (sx, sy) = ttf.decode_image_draft(data, 32)
        assert sx == sy == 0.125


def test_augmentations_are_bit_equal():
    rng = np.random.default_rng(4)
    img = textured(rng, 30, 40)
    cam = rng.normal(size=18).astype(np.float32)
    assert np.array_equal(ttf.hflip(img), jtf.hflip(img))
    assert np.array_equal(ttf.hflip_camera(cam), jtf.hflip_camera(cam))
    assert np.array_equal(ttf.jpeg_compress(img, 60), jtf.jpeg_compress(img,
                                                                        60))
    assert np.array_equal(ttf.adjust_hsv(img, 0.1, 0.2, -0.1),
                          jtf.adjust_hsv(img, 0.1, 0.2, -0.1))
    assert np.array_equal(ttf.gaussian_blur(img, 1.5),
                          jtf.gaussian_blur(img, 1.5))
    import random
    intr = np.asarray([30.0, 30.0, 20.0, 15.0], np.float32)
    a = ttf.random_crop_and_resize(img, 16, random.Random(5), 0.6, intr)
    b = jtf.random_crop_and_resize(img, 16, random.Random(5), 0.6, intr)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    out, out_intr = ttf.center_crop_and_resize(img, 16, intr)
    ref, ref_intr = jtf.center_crop_and_resize(img, 16, intr)
    assert np.array_equal(out, ref) and np.array_equal(out_intr, ref_intr)
    assert np.array_equal(ttf.normalize_image(img), jtf.normalize_image(img))


def test_file_readers_match_jax(tmp_path):
    files = {"a/b.txt": b"hello", "a/c/d.bin": bytes(range(7)),
             "e.txt": b"x"}
    for name, data in files.items():
        os.makedirs(tmp_path / "dir" / os.path.dirname(name), exist_ok=True)
        (tmp_path / "dir" / name).write_bytes(data)
    with zipfile.ZipFile(tmp_path / "d.zip", "w") as zf:
        for name, data in files.items():
            zf.writestr(name, data)
    with tarfile.open(tmp_path / "d.tar", "w") as tf:
        tf.add(tmp_path / "dir", arcname=".")
    with tarfile.open(tmp_path / "d.tar") as tf:
        names = [m.name for m in tf.getmembers() if m.isfile()]
    for path in ("dir", "d.zip", "d.tar"):
        t, j = (m.make_reader(str(tmp_path / path)) for m in (tds, jds))
        assert type(t).__name__ == type(j).__name__
        assert t.list() == j.list()
        for name in (names if path == "d.tar" else files):
            assert tds.fetch_file(t, name) == j.fetch(name)
            assert t.exists(name) and not t.exists(name + "_")
    (tmp_path / "db").mkdir()
    (tmp_path / "db" / "data.mdb").write_bytes(b"")
    try:                                  # lmdb is optional in both
        import lmdb  # noqa: F401
    except ImportError:
        for m in (tds, jds):
            with pytest.raises(ImportError):
                m.make_reader(str(tmp_path / "db"))


def test_camera_helpers_match_jax():
    rng = np.random.default_rng(6)
    poses = orbit_c2w(5, radius=1.7).astype(np.float32)
    poses[:, :, 3] += rng.normal(size=(5, 3)).astype(np.float32) * 0.1
    t = torch.from_numpy(poses)
    j = jnp.asarray(poses)
    for name in ("opencv_to_opengl", "opengl_to_opencv", "llff_to_opengl",
                 "matrix_to_square"):
        out = getattr(tcam, name)(t)
        assert isinstance(out, torch.Tensor)
        np.testing.assert_allclose(out.numpy(), getattr(jcam, name)(j),
                                   rtol=0, atol=1e-6)
        # the numpy versions the datasets use are the JAX package's, exactly
        assert np.array_equal(getattr(tcam, name)(poses),
                              getattr(jcam, name)(poses))
    for nv in (-1, 3):
        out, tn = tcam.normalize_poses(t, nv)
        ref, rn = jcam.normalize_poses(j, nv)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(tn), float(rn), rtol=1e-6)
    rots = t[:, :, :3]
    assert bool(tcam.check_valid_rotations(rots)) == bool(
        jcam.check_valid_rotations(j[:, :, :3])) is True
    bad = rots.clone()
    bad[2, 0, 0] += 0.01
    assert bool(tcam.check_valid_rotations(bad)) == bool(
        jcam.check_valid_rotations(jnp.asarray(bad.numpy()))) is False
    cams = np.concatenate([poses.reshape(5, 12), np.tile(
        [[30.0, 28.0, 16.0, 12.0, 24.0, 32.0]], (5, 1))], 1).astype(
            np.float32)
    for hw in ((None, None), (48, 64)):
        fx, fy = tcam.camera_fov(torch.from_numpy(cams), *hw)
        rx, ry = jcam.camera_fov(jnp.asarray(cams), *hw)
        np.testing.assert_allclose(fx.numpy(), rx, rtol=0, atol=1e-6)
        np.testing.assert_allclose(fy.numpy(), ry, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# datasets, index by index
# ---------------------------------------------------------------------------

def dataset_pair(name, corpus):
    """The same dataset built by both packages."""
    data, base = corpus["data"], corpus["base"]
    kinds = {
        "dl3dv": ("DL3DV10KDataset",
                  dict(root_dir=os.path.join(base, "dl3dv_ann"),
                       annotation_path=corpus["ann"], img_size=16,
                       num_input_views=4, num_novel_views=2, sample_rate=1,
                       drop_text_p=0.5)),
        "mvimgnet": ("MVImgNetDataset",
                     dict(root_dir=os.path.join(data, "mvimgnet"),
                          img_size=16, num_input_views=3, num_novel_views=3,
                          sample_rate=-1)),
        "urbangen": ("UrbanGenDataset",
                     dict(root_dir=os.path.join(data, "urbangen"),
                          img_size=16, num_input_views=4, sample_rate=2,
                          sub_sample_rates={"kitti360": 1})),
        "objaverse": ("ObjaverseDataset",
                      dict(root_dir=os.path.join(data, "objaverse"),
                           img_size=16, num_input_views=5,
                           caption_csv=os.path.join(base, "captions.csv"),
                           prompt_prefix="a")),
        "repeat_pad": ("DL3DV10KDataset",
                       dict(root_dir=os.path.join(base, "dl3dv_ann"),
                            annotation_path=corpus["ann"], img_size=16,
                            num_input_views=8, fake_length=9)),
        "re10k": ("RealEstate10KDataset",
                  dict(root_dir=os.path.join(data, "re10k/train"),
                       img_size=16, num_input_views=3, num_novel_views=1,
                       sample_rate=2, scene_scale_threshold=0.01)),
        "t2i": ("Text2ImageDataset",
                dict(root_dir=os.path.join(data, "sam1b"), img_size=16,
                     images_per_iter=3, drop_text_p=0.3)),
    }
    cls, kw = kinds[name]
    return getattr(tds, cls)(**kw), getattr(jds, cls)(**kw)


@pytest.mark.parametrize("name", ["dl3dv", "mvimgnet", "urbangen",
                                  "objaverse", "repeat_pad", "re10k", "t2i"])
def test_dataset_items_match_jax(corpus, name):
    port, ref = dataset_pair(name, corpus)
    assert isinstance(port, torch.utils.data.Dataset)
    assert len(port) == len(ref) > 0
    for idx in range(len(ref)):
        assert_items_equal(port[idx], ref[idx])


def test_re10k_eval_matches_jax(corpus, tmp_path):
    index = {"aaa": {"context": [0, 5], "target": [2, 3]}, "bbb": None}
    with open(tmp_path / "eval.json", "w") as fp:
        json.dump(index, fp)
    kw = dict(root_dir=os.path.join(corpus["data"], "re10k/test"),
              eval_index_path=str(tmp_path / "eval.json"), img_size=16,
              num_input_views=2, num_novel_views=2)
    port, ref = (m.RealEstate10KDatasetEval(**kw) for m in (tds, jds))
    assert len(port) == len(ref) == 1
    assert_items_equal(port[0], ref[0])


def test_mixers_fake_length_and_retry_match_jax(corpus):
    pairs = [dataset_pair(n, corpus) for n in ("dl3dv", "mvimgnet", "t2i")]
    (dl_t, dl_j), (mv_t, mv_j), (t2i_t, t2i_j) = pairs
    prob = (tds.ProbDataset([dl_t, mv_t], probs=[0.6, 0.4], fake_length=11),
            jds.ProbDataset([dl_j, mv_j], probs=[0.6, 0.4], fake_length=11))
    joint = (tds.JointDataset([prob[0], t2i_t]),
             jds.JointDataset([prob[1], t2i_j]))
    for p, j in (prob, joint):
        assert len(p) == len(j) == 11
        for idx in range(len(j)):
            assert_items_equal(p[idx], j[idx])
    # the scene-scale rejection: scenes below the threshold are retried
    # with indices from the item's generator, or exhaust the retries
    root = os.path.join(corpus["base"], "dl3dv_ann")
    for thr, retries in ((3.0, 10), (1e9, 3)):
        kw = dict(root_dir=root, annotation_path=corpus["ann"], img_size=16,
                  num_input_views=4, scene_scale_threshold=thr,
                  max_retries=retries, fake_length=6)
        port, ref = (m.DL3DV10KDataset(**kw) for m in (tds, jds))
        for idx in range(6):
            try:
                want = ref[idx]
            except RuntimeError:
                with pytest.raises(RuntimeError, match="consecutive"):
                    port[idx]
                continue
            assert_items_equal(port[idx], want)
    # a child that always fails: ProbDataset falls through to the other
    bad = tds.DL3DV10KDataset(root, annotation_path=corpus["ann"],
                              img_size=16, scene_scale_threshold=1e9,
                              max_retries=1)
    bad_j = jds.DL3DV10KDataset(root, annotation_path=corpus["ann"],
                                img_size=16, scene_scale_threshold=1e9,
                                max_retries=1)
    p = tds.ProbDataset([bad, mv_t], probs=[0.9, 0.1])
    j = jds.ProbDataset([bad_j, mv_j], probs=[0.9, 0.1])
    for idx in range(5):
        assert_items_equal(p[idx], j[idx])
    with pytest.raises(KeyError, match="overlap"):
        tds.JointDataset([dl_t, mv_t])[0]


def test_t2i_annotation_formats_and_captions(tmp_path):
    import csv
    rng = np.random.default_rng(8)
    for i in range(4):
        Image.fromarray(textured(rng, 20, 20)).save(tmp_path / f"i{i}.jpg")
    (tmp_path / "metadata").mkdir()
    for shard in range(2):
        with open(tmp_path / "metadata" /
                  f"filenames_and_captions_{shard}.csv", "w",
                  newline="") as fp:
            w = csv.writer(fp)
            w.writerow(["Image Name", "Image Path", "Caption"])
            for i in (2 * shard, 2 * shard + 1):
                w.writerow([f"i{i}.jpg", f"i{i}.jpg", f"a photo of  x {i}"])
    with open(tmp_path / "dict.json", "w") as fp:
        json.dump({f"i{i}.jpg": f"this image shows {i}" for i in range(4)},
                  fp)
    for ann in (None, str(tmp_path / "dict.json")):
        kw = dict(root_dir=str(tmp_path), annotation_path=ann,
                  images_per_iter=2, img_size=8)
        port, ref = (m.Text2ImageDataset(**kw) for m in (tds, jds))
        assert port.items == ref.items and len(port) == 4
        for idx in range(4):
            assert_items_equal(port[idx], ref[idx])
    for text in ("The image shows a red car.", "  hello   world ",
                 "A photo of dogs", ""):
        assert tds.clean_caption(text) == jds.clean_caption(text)


def test_legacy_formats_refused():
    """The legacy formats resolve by their names, dotted or not (their
    parity with JAX is in ``test_torch_legacy_datasets.py``); an unknown
    name is refused."""
    for name in ("CO3DDataset", "prometheus_torch.datasets.ShapeNetDataset",
                 "LegacyMixingDataset"):
        assert tds.get_dataset(name) is getattr(tds, name.rsplit(".")[-1])
    with pytest.raises(KeyError, match="unknown dataset"):
        tds.get_dataset("NoSuchDataset")


# ---------------------------------------------------------------------------
# config composition and the dataset groups
# ---------------------------------------------------------------------------

def renamed(cfg) -> dict:
    return json.loads(json.dumps(dict(cfg)).replace("prometheus_tpu.",
                                                    "prometheus_torch."))


@pytest.mark.parametrize("experiment", EXPERIMENTS)
@pytest.mark.parametrize("dataset", DATASET_GROUPS)
def test_load_config_matches_jax(experiment, dataset):
    overrides = [f"experiment={experiment}", f"dataset={dataset}",
                 "gsdecoder=gsdecoder_dit", "training.batch_size=3",
                 "data_root=/data/x", "image_size=64"]
    port = tconfig.load_config(os.path.join(TORCH_CONFIGS, "config.yaml"),
                               overrides)
    ref = jconfig.load_config(os.path.join(JAX_CONFIGS, "config.yaml"),
                              overrides)
    assert dict(port) == renamed(ref)
    assert port.training.batch_size == 3 and port.chosen.dataset == dataset
    assert port.image_size == 64 and port.data_root == "/data/x"
    assert isinstance(port.training, tconfig.Config)


@pytest.mark.parametrize("refiner", ["mv_sds_pp", "sds_pp"])
def test_refiner_group_matches_jax(refiner):
    """The ``refiner`` group composes in the port as in JAX; only the
    ``module`` path's package differs."""
    port = tconfig.load_config(overrides=[f"refiner={refiner}"])
    ref = jconfig.load_config(os.path.join(JAX_CONFIGS, "config.yaml"),
                              [f"refiner={refiner}"])
    assert dict(port) == renamed(ref)
    assert port.refiner["module"].startswith("prometheus_torch.refiners.")
    assert ref["refiner"]["module"].startswith("prometheus_tpu.refiners.")
    assert port.chosen.refiner == refiner


def test_config_defaults_and_algorithm_swap():
    port = tconfig.load_config(overrides=["algorithm=mvldm_imgcond"])
    ref = jconfig.load_config(os.path.join(JAX_CONFIGS, "config.yaml"),
                              ["algorithm=mvldm_imgcond"])
    assert dict(port) == renamed(ref)
    assert port.algorithm["network"]["image_encoder"]["width"] == 1280
    assert port.get_path("training.single_view_num") == 4
    assert port.dataset["train"]["datasets"][1]["args"][
        "images_per_iter"] == 4
    with pytest.raises(ValueError, match="key=value"):
        tconfig.load_config(overrides=["not_an_override"])


@pytest.fixture(scope="module")
def builds(corpus):
    """Each dataset group, built by both packages over ``corpus``."""
    out = {}
    for group in DATASET_GROUPS:
        ov = [f"dataset={group}", f"data_root={corpus['data']}",
              "image_size=16", "training.num_input_views=3",
              "training.num_novel_views=1", "training.single_view_num=2"]
        pair = []
        for cfgmod, bmod, root in ((tconfig, tbuilder, TORCH_CONFIGS),
                                   (jconfig, jbuilder, JAX_CONFIGS)):
            cfg = cfgmod.load_config(os.path.join(root, "config.yaml"), ov)
            ds = dict(cfg["dataset"])
            pair.append(bmod.build_dataset(
                dict(ds["train"]), bmod.common_kwargs_from_group(ds)))
        out[group] = pair
    return out


@pytest.mark.parametrize("group", DATASET_GROUPS)
def test_build_dataset_groups_match_jax(builds, group):
    port, ref = builds[group]
    assert type(port).__name__ == type(ref).__name__
    assert len(port) == len(ref)
    for idx in range(min(len(ref), 6)):
        assert_items_equal(port[idx], ref[idx])


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

def test_loader_batches_match_jax(builds):
    port_ds, ref_ds = builds["mvldm_dataset"]
    loader = tds.make_loader(port_ds, 3, num_workers=2, seed=5)
    ref = jds.DataLoader(ref_ds, batch_size=3, num_workers=2, seed=5)
    assert len(loader) == len(ref) == len(ref_ds) // 3
    for _ in range(2):                    # two epochs: seeds 6 and 7
        got, want = list(loader), list(ref)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert isinstance(a["images_mv"], torch.Tensor)
            assert isinstance(a["text_sv"], list) and len(a["text_sv"]) == 3
            assert_items_equal(a, b)


@pytest.mark.parametrize("workers", [0, 1])
def test_loader_raises_a_worker_error(tmp_path, workers):
    """A worker's exception reaches the caller (a T2I item whose file is
    missing, with ``debug`` on so the item does not retry)."""
    with open(tmp_path / "annotations.json", "w") as fp:
        json.dump([{"file": "missing.jpg", "caption": "c"}], fp)
    ds = tds.Text2ImageDataset(str(tmp_path), images_per_iter=1, debug=True,
                               fake_length=4)
    with pytest.raises(FileNotFoundError, match="missing.jpg"):
        list(tds.make_loader(ds, 2, num_workers=workers))


def test_sampler_order_and_collate():
    s = tds.ShuffledBatchSampler(10, 3, seed=2)
    epoch1 = list(s)
    order = np.arange(10)
    np.random.default_rng(3).shuffle(order)
    assert epoch1 == [order[i:i + 3].tolist() for i in (0, 3, 6)]
    assert len(s) == 3
    order = np.arange(10)                    # the second epoch: seed 2 + 2
    np.random.default_rng(4).shuffle(order)
    assert list(s) == [order[i:i + 3].tolist() for i in (0, 3, 6)]
    items = [{"a": np.ones((2, 2), np.float32) * i, "n": i, "s": f"t{i}",
              "l": [f"x{i}", f"y{i}"]} for i in range(3)]
    out = tds.collate(items)
    ref = jds.default_collate(items)
    assert torch.equal(out["a"], torch.from_numpy(ref["a"]))
    assert torch.equal(out["n"], torch.tensor([0, 1, 2]))
    assert out["s"] == ref["s"] and out["l"] == ref["l"]


# ---------------------------------------------------------------------------
# snapshot utilities and the NaN guard
# ---------------------------------------------------------------------------

def test_snapshot_utilities_match_jax(tmp_path):
    from prometheus_tpu.logging_utils import MetricLogger as JaxLogger
    from prometheus_torch.logging_utils import MetricLogger

    rng = np.random.default_rng(9)
    frames = [textured(rng, 12, 16) for _ in range(4)]
    for m, d in ((timage, "t"), (jimage, "j")):
        (tmp_path / d).mkdir()
        m.save_gif(frames, str(tmp_path / d / "a.gif"), duration_ms=50,
                   size=(24, 20))
        grid = m.ImageGrid(2, 3, spacing=2)
        for i, f in enumerate(frames):
            grid.add(i // 3, i % 3, f if i else textured(rng, 12, 16)[:8])
        np.save(tmp_path / d / "grid.npy", grid.compose())
    assert (tmp_path / "t" / "a.gif").read_bytes() == \
        (tmp_path / "j" / "a.gif").read_bytes()
    assert np.array_equal(np.load(tmp_path / "t" / "grid.npy")[:, 20:],
                          np.load(tmp_path / "j" / "grid.npy")[:, 20:])
    cams = np.concatenate([orbit_c2w(6).reshape(6, 12), np.tile(
        [[30.0, 30.0, 16.0, 12.0, 24.0, 32.0]], (6, 1))], 1)
    assert np.array_equal(tvis.frustum_corners(cams[1]),
                          jvis.frustum_corners(cams[1]))
    for m, d in ((tvis, "t"), (jvis, "j")):
        m.export_cameras_ply(str(tmp_path / d / "cams"), cams[None])
        m.plot_cameras_png(str(tmp_path / d / "cams.png"), cams)
        m.write_html_gallery(str(tmp_path / d / "g.html"),
                             [{"title": "s", "images": ["a.png"],
                               "video": "v.mp4"}])
    for name in ("cams.ply", "g.html"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    png = [np.asarray(Image.open(tmp_path / d / "cams.png"))
           for d in ("t", "j")]
    assert np.array_equal(*png) and png[0].min() < 255
    rows = [frames[:2], frames[2:]]
    for cls, d in ((MetricLogger, "tl"), (JaxLogger, "jl")):
        log = cls(str(tmp_path / d))
        log.log_metrics({"loss": np.float32(0.5), "name": "x"}, 3)
        log.log_grid("val/grid", rows, 7)
        log.log_gif("val_gif", frames, 7, duration_ms=200)
        log.finish()
    for name in ("000000007_val_grid.png", "000000007_val_gif.gif"):
        a, b = (tmp_path / d / "snapshots" / name for d in ("tl", "jl"))
        assert np.array_equal(np.asarray(Image.open(a).convert("RGB")),
                              np.asarray(Image.open(b).convert("RGB")))
    line = json.loads((tmp_path / "tl" / "metrics.jsonl").read_text())
    assert line["step"] == 3 and line["loss"] == 0.5 and line["name"] == "x"


def test_nan_guard(capsys):
    clean = {"a": torch.ones(3), "b": [np.zeros(2)], "t": ["text"]}
    assert check_finite(clean, "clean") is clean
    assert_finite(clean, "clean")
    bad = {"a": torch.ones(3), "b": [np.array([0.0, np.nan])],
           "c": torch.tensor([float("inf")]), "i": np.array([1])}
    with pytest.raises(FloatingPointError, match=r"batch@step4.*'b'.*'c'"):
        assert_finite(bad, "batch@step4")
    check_finite(bad, "vae.decode")
    assert "NON-FINITE values in vae.decode" in capsys.readouterr().out
