"""Port parity for the native host data plane (``prometheus_torch/native``)
against the JAX package's (``prometheus_tpu/native``): the same C++ source
and flags, so every entry point is held bit-equal:

- ``center_crop_resize_normalize`` on seeded images of odd sizes, portrait
  and landscape, and ``u8_to_chw_f32``;
- ``decode_jpeg_crop_resize_normalize`` at ``max_denom`` 1 and 8, with the
  decoded size and scale;
- ``encode_splat`` with and without pruning;
- ``datasets.transforms.decode_crop_resize_normalize`` with the data plane
  on in both packages (JPEG through libjpeg, PNG through PIL, the
  intrinsics in both ``normalized`` modes), and with
  ``PROMETHEUS_NATIVE=0`` (PIL LANCZOS) and ``PROMETHEUS_JPEG_DRAFT=0``.

Also: the library lands under ``build/prometheus_torch/``, a compile
failure raises with the compiler's output, and the loader's worker
processes take the switches from the caller's environment.
"""
import ctypes
import io
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from prometheus_tpu import native as jnative
from prometheus_tpu.datasets import transforms as jtf
from prometheus_torch import native as tnative
from prometheus_torch.datasets import make_loader
from prometheus_torch.datasets import transforms as ttf
from test_torch_sampler_modes import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def textured(rng, h, w):
    """A smooth pattern with noise (uint8 HWC)."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([127 + 80 * np.sin(yy / (5 + 3 * c)) * np.cos(xx / (7 + c))
                    for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)


def encoded(img, fmt="JPEG"):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt, quality=90)
    return buf.getvalue()


IMAGES = {"odd_landscape": (37, 53), "odd_portrait": (61, 29),
          "camera_frame": (720, 960)}


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return {k: textured(rng, *hw) for k, hw in IMAGES.items()}


def test_builds_into_build_dir():
    path = tnative.build()
    assert path.parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR == type(path)(ROOT) / "build" / "prometheus_torch"
    assert path.exists() and tnative.available()
    assert tnative.jpeg_available() == path.name.startswith(
        "prometheus_io-jpeg-")
    assert tnative.jpeg_available()           # libjpeg is on this machine


def test_source_is_the_jax_source():
    """The copy differs from the JAX file only in its header comment."""
    def body(path):
        text = open(path).read()
        return text[text.index("#include <cstdint>"):]

    assert body(tnative.SOURCE) == body(os.path.join(
        ROOT, "prometheus_tpu", "native", "prometheus_io.cpp"))


def test_compile_failure_raises_with_the_output(tmp_path, monkeypatch):
    broken = tmp_path / "prometheus_io.cpp"
    broken.write_text("int f( {\n")
    monkeypatch.setattr(tnative, "SOURCE", broken)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        tnative.build()


def test_libjpeg_that_does_not_load_falls_back(monkeypatch):
    """A libjpeg variant that builds but does not load (its runtime library
    missing) gives way to the transform-only variant; if that does not
    load either, the build raises with the loader's message."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_jpeg", False)
    bind = tnative._bind

    def no_libjpeg(path):
        if path.name.startswith("prometheus_io-jpeg-"):
            raise OSError("libjpeg.so.8: cannot open shared object file")
        return bind(path)

    monkeypatch.setattr(tnative, "_bind", no_libjpeg)
    path = tnative.build()
    assert path == tnative.library_path(False) and path.exists()
    assert tnative.available() and not tnative.jpeg_available()
    img = textured(np.random.default_rng(1), 40, 56)
    assert np.array_equal(tnative.center_crop_resize_normalize(img, 24),
                          jnative.center_crop_resize_normalize(img, 24))
    assert tnative.decode_jpeg_crop_resize_normalize(b"\xff\xd8", 24) is None

    def nothing_loads(path):
        raise OSError(f"{path.name}: cannot open shared object file")

    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_bind", nothing_loads)
    with pytest.raises(RuntimeError, match="(?s)does not load.*"
                                           "does not load"):
        tnative.build()


@pytest.mark.parametrize("name", list(IMAGES))
@pytest.mark.parametrize("size", [32, 24])
def test_crop_resize_normalize_bit_equal(images, name, size):
    img = images[name]
    out = tnative.center_crop_resize_normalize(img, size)
    ref = jnative.center_crop_resize_normalize(img, size)
    assert out.shape == (3, size, size) and out.dtype == np.float32
    assert np.array_equal(out, ref)


def test_u8_to_chw_f32_bit_equal(images, monkeypatch):
    """The JAX package binds this entry point without a wrapper: the port's
    wrapper against JAX's bound C function, natively and in numpy."""
    img = np.ascontiguousarray(images["odd_portrait"])
    ref = np.empty((3,) + img.shape[:2], np.float32)
    jnative.get_lib().u8_to_chw_f32(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), *img.shape[:2],
        ref.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    assert np.array_equal(tnative.u8_to_chw_f32(img), ref)
    monkeypatch.setenv("PROMETHEUS_NATIVE", "0")
    assert np.array_equal(tnative.u8_to_chw_f32(img), ref)


@pytest.mark.parametrize("name", list(IMAGES))
@pytest.mark.parametrize("max_denom", [1, 8])
def test_decode_jpeg_bit_equal(images, name, max_denom):
    data = encoded(images[name])
    out = tnative.decode_jpeg_crop_resize_normalize(data, 32, max_denom)
    ref = jnative.decode_jpeg_crop_resize_normalize(data, 32, max_denom)
    assert np.array_equal(out[0], ref[0])
    assert out[1:] == ref[1:]
    if name == "camera_frame":    # the DCT downscale ran only when asked
        assert out[2] == ((720, 960) if max_denom == 1 else (90, 120))


def test_entry_points_reject_wrong_shapes():
    """The library reads as many bytes as the shapes say: a wrong shape
    raises before any pointer is passed."""
    with pytest.raises(ValueError):
        tnative.center_crop_resize_normalize(np.zeros((8, 8), np.uint8), 4)
    with pytest.raises(ValueError):
        tnative.u8_to_chw_f32(np.zeros((8, 8, 4), np.uint8))
    g = [np.zeros((1, 5, 3)), np.zeros((1, 5, 1, 3)), np.zeros((1, 5, 1)),
         np.zeros((1, 5, 3)), np.zeros((1, 5, 3))]      # 3 rotation values
    with pytest.raises(ValueError):
        tnative.encode_splat(g)


def test_decode_jpeg_declines_other_files(images):
    assert tnative.decode_jpeg_crop_resize_normalize(
        encoded(images["odd_portrait"], "PNG"), 32) is None
    assert tnative.decode_jpeg_crop_resize_normalize(b"\xff\xd8junk",
                                                     32) is None


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_encode_splat_bit_equal(threshold):
    rng = np.random.default_rng(1)
    n = 300
    g = (rng.normal(size=(1, n, 3)).astype(np.float32),
         rng.uniform(0.1, 0.9, size=(1, n, 1, 3)).astype(np.float32),
         rng.uniform(0.0, 1.0, size=(1, n, 1)).astype(np.float32),
         rng.uniform(0.01, 0.2, size=(1, n, 3)).astype(np.float32),
         rng.normal(size=(1, n, 4)).astype(np.float32))
    out = tnative.encode_splat(g, threshold)
    assert out == jnative.encode_splat(g, threshold)
    assert len(out) // 32 == int((g[2] >= threshold).sum())
    # tensors are accepted as they are
    assert tnative.encode_splat(tuple(torch.from_numpy(a) for a in g),
                                threshold) == out


@pytest.mark.parametrize("kind", ["jpeg_frame", "jpeg_small", "png"])
@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("env", [{}, {"PROMETHEUS_NATIVE": "0"},
                                 {"PROMETHEUS_JPEG_DRAFT": "0"}],
                         ids=["native", "python", "no_draft"])
def test_decode_crop_resize_normalize_matches_jax(images, kind, normalized,
                                                  env, monkeypatch):
    for k in ("PROMETHEUS_NATIVE", "PROMETHEUS_JPEG_DRAFT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    img = images["camera_frame" if kind == "jpeg_frame" else "odd_landscape"]
    data = encoded(img, "PNG" if kind == "png" else "JPEG")
    intr = (np.asarray([0.9, 1.2, 0.5, 0.45], np.float32) if normalized
            else np.asarray([700.0, 690.0, 480.0, 355.0], np.float32))
    out, out_intr = ttf.decode_crop_resize_normalize(data, 32, intr,
                                                     normalized=normalized)
    ref, ref_intr = jtf.decode_crop_resize_normalize(data, 32, intr,
                                                     normalized=normalized)
    assert out.shape == (3, 32, 32) and out.dtype == np.float32
    assert np.array_equal(out, ref) and np.array_equal(out_intr, ref_intr)
    # which path ran: the native transform differs from PIL's LANCZOS
    pil, _ = jtf.center_crop_and_resize(
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), 32)
    if env == {} and kind == "png":
        assert np.array_equal(out, tnative.center_crop_resize_normalize(
            np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), 32))
    if env == {"PROMETHEUS_NATIVE": "0"} and kind != "jpeg_frame":
        assert np.array_equal(out, jtf.normalize_image(pil))


class EnvDataset(torch.utils.data.Dataset):
    """Each item: what the worker process reads of the switches."""

    def __len__(self):
        return 2

    def __getitem__(self, i):
        return {"native": os.environ.get("PROMETHEUS_NATIVE", "unset"),
                "draft": os.environ.get("PROMETHEUS_JPEG_DRAFT", "unset")}


def test_loader_workers_take_the_callers_switches(monkeypatch):
    monkeypatch.setenv("PROMETHEUS_NATIVE", "0")
    monkeypatch.delenv("PROMETHEUS_JPEG_DRAFT", raising=False)
    batch = next(iter(make_loader(EnvDataset(), 2, num_workers=1)))
    assert batch["native"] == ["0", "0"] and batch["draft"] == ["unset"] * 2
    monkeypatch.setenv("PROMETHEUS_NATIVE", "1")
    monkeypatch.setenv("PROMETHEUS_JPEG_DRAFT", "0")
    batch = next(iter(make_loader(EnvDataset(), 2, num_workers=1)))
    assert batch["native"] == ["1", "1"] and batch["draft"] == ["0", "0"]


def test_library_is_not_built_into_the_package():
    pkg = os.path.dirname(tnative.SOURCE)
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]
    assert shutil.which("g++")
