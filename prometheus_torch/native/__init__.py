"""The native host data plane (``prometheus_tpu/native/``): C++ decode,
resize and ``.splat`` packing bound over ``ctypes``.

``prometheus_io.cpp`` beside this file is a copy of the JAX package's
source with the same arithmetic. At first use it is built with ``g++ -O3
-shared -fPIC -std=c++17`` into ``build/prometheus_torch/`` at the root of
the checkout, named after a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused. The build tries
``-DPROMETHEUS_JPEG -ljpeg`` first (libjpeg's DCT-downscaled decode fused
with the transform); where libjpeg is missing, at build time or when the
library is loaded, it builds and loads the transform-only library, and
``jpeg_available()`` says which one is in use. If neither builds and
loads, the first use raises with the compiler's output and the loader's
message.

``PROMETHEUS_NATIVE=0`` turns the data plane off, as in the JAX package:
``center_crop_resize_normalize`` and ``encode_splat`` then take their
PIL / numpy versions and ``decode_jpeg_crop_resize_normalize`` returns
``None`` (the caller decodes in Python).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("prometheus_io.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "prometheus_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
JPEG_FLAGS = ("-DPROMETHEUS_JPEG",)
JPEG_LIBS = ("-ljpeg",)

_lib = None
_jpeg = False


def library_path(jpeg: bool) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + (JPEG_FLAGS if jpeg else ())).encode())
    name = "prometheus_io-jpeg" if jpeg else "prometheus_io"
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _compile(out: Path, jpeg: bool) -> subprocess.CompletedProcess:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, *(JPEG_FLAGS if jpeg else ()), str(SOURCE),
           "-o", str(tmp), *(JPEG_LIBS if jpeg else ())]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode == 0:
        os.replace(tmp, out)      # atomic: concurrent workers may build too
    return res


def build() -> Path:
    """Build (where it is not built yet) and bind the library, and return
    its path: the libjpeg variant where it builds and loads, else the
    transform-only one. Raises with ``g++``'s output and the loader's
    message if neither does."""
    global _lib, _jpeg
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    errors = []
    for jpeg in (True, False):
        path = library_path(jpeg)
        if not path.exists():
            res = _compile(path, jpeg)
            if res.returncode != 0:
                errors.append(f"g++ failed to build {path.name}:\n"
                              + res.stdout + res.stderr)
                continue
        try:
            lib = _bind(path)
        except OSError as e:
            errors.append(f"{path.name} does not load: {e}")
            continue
        _lib, _jpeg = lib, jpeg
        return path
    raise RuntimeError("prometheus_io.cpp: no variant builds and loads\n"
                       + "\n".join(errors))


def _bind(path: Path):
    lib = ctypes.CDLL(str(path))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.center_crop_resize_normalize.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p]
    lib.center_crop_resize_normalize.restype = ctypes.c_int
    lib.u8_to_chw_f32.argtypes = [u8p, ctypes.c_int, ctypes.c_int, f32p]
    lib.u8_to_chw_f32.restype = ctypes.c_int
    lib.encode_splat.argtypes = [f32p, f32p, f32p, f32p, f32p,
                                 ctypes.c_int, ctypes.c_float, u8p]
    lib.encode_splat.restype = ctypes.c_int
    if hasattr(lib, "decode_jpeg_crop_resize_normalize"):
        lib.decode_jpeg_crop_resize_normalize.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
            ctypes.POINTER(ctypes.c_int)]
        lib.decode_jpeg_crop_resize_normalize.restype = ctypes.c_int
    return lib


def get_lib():
    """The bound library, built at first use; ``None`` when
    ``PROMETHEUS_NATIVE=0``."""
    global _lib, _jpeg
    if os.environ.get("PROMETHEUS_NATIVE", "1") == "0":
        return None
    if _lib is None:
        build()
    return _lib


def available() -> bool:
    return get_lib() is not None


def jpeg_available() -> bool:
    """Whether the library in use links libjpeg (the fused JPEG path)."""
    return get_lib() is not None and _jpeg


def _rgb(img) -> np.ndarray:
    """A C-contiguous uint8 ``(H, W, 3)`` array, or ``ValueError``: the
    library reads ``3 H W`` bytes from its pointer."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3 or 0 in img.shape:
        raise ValueError(f"expected a (H, W, 3) image, got {img.shape}")
    return img


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def center_crop_resize_normalize(img: np.ndarray, out_size: int) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 (3, out, out) in [-1, 1]: the native
    antialiased resize, or PIL's LANCZOS with the data plane off."""
    lib = get_lib()
    img = _rgb(img)
    h, w = img.shape[:2]
    if lib is not None:
        dst = np.empty((3, out_size, out_size), np.float32)
        if lib.center_crop_resize_normalize(_u8p(img), h, w, out_size,
                                            _f32p(dst)) == 0:
            return dst
    from ..datasets.transforms import center_crop_and_resize, normalize_image

    out, _ = center_crop_and_resize(img, out_size)
    return normalize_image(out)


def u8_to_chw_f32(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 (3, H, W) in [-1, 1], no resize: ``x *
    (1 / 127.5) - 1`` in float32, natively or, with the data plane off, in
    numpy with the same two roundings."""
    img = _rgb(img)
    h, w = img.shape[:2]
    lib = get_lib()
    if lib is None:
        chw = np.moveaxis(img, -1, 0).astype(np.float32)
        return chw * np.float32(1.0 / 127.5) - np.float32(1.0)
    dst = np.empty((3, h, w), np.float32)
    lib.u8_to_chw_f32(_u8p(img), h, w, _f32p(dst))
    return dst


def decode_jpeg_crop_resize_normalize(data: bytes, out_size: int,
                                      max_denom: int = 8):
    """JPEG bytes -> ``(chw_f32 (3, S, S) in [-1, 1], (sx, sy), (dec_h,
    dec_w))`` in one native call: libjpeg's DCT-downscaled decode (the
    largest 1/2^k <= ``max_denom`` that keeps the short side >= ``S``; 1
    decodes at full size) fused with the crop, resize and normalisation.
    ``(sx, sy)`` is the decoded over the full size, per axis, for the
    intrinsics.

    Returns ``None`` when the data plane is off, the library was built
    without libjpeg, or libjpeg declines the file (not a JPEG, corrupt, an
    exotic colour space): the caller then decodes in Python."""
    lib = get_lib()
    if lib is None or not _jpeg:
        return None
    buf = np.frombuffer(data, np.uint8)
    dst = np.empty((3, out_size, out_size), np.float32)
    dims = np.zeros(4, np.int32)
    rc = lib.decode_jpeg_crop_resize_normalize(
        _u8p(buf), len(data), out_size, max_denom, _f32p(dst),
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if rc != 0:
        return None
    return (dst, (float(dims[2]) / dims[0], float(dims[3]) / dims[1]),
            (int(dims[3]), int(dims[2])))


def _numpy(a) -> np.ndarray:
    if hasattr(a, "detach"):                       # a torch tensor
        a = a.detach().float().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a, np.float32))


def encode_splat(gaussians, opacity_threshold: float = 0.0) -> bytes:
    """Gaussians ``(xyz, features, opacity, scales, rotations)`` (numpy
    arrays or tensors, batched by one scene or not) -> packed ``.splat``
    bytes, sorted by volume x opacity, the records whose opacity is below
    ``opacity_threshold`` pruned."""
    xyz, feats, opacity, scales, rots = (_numpy(a) for a in gaussians)
    if xyz.ndim == 3:
        xyz, feats, opacity, scales, rots = (
            a[0] for a in (xyz, feats, opacity, scales, rots))
    n = xyz.shape[0]
    if (xyz.shape != (n, 3) or scales.shape != (n, 3) or rots.shape != (n, 4)
            or feats.size < 3 * n or opacity.size != n):
        raise ValueError("encode_splat: expected (N, 3) means and scales, "
                         "(N, 4) rotations, N opacities and >= 3 feature "
                         "channels a gaussian")
    rgb = np.ascontiguousarray(feats.reshape(n, -1)[:, :3])
    op = np.ascontiguousarray(opacity.reshape(n))
    scales, rots = np.ascontiguousarray(scales), np.ascontiguousarray(rots)
    lib = get_lib()
    if lib is not None:
        out = np.empty(32 * n, np.uint8)
        cnt = lib.encode_splat(_f32p(xyz), _f32p(rgb), _f32p(op),
                               _f32p(scales), _f32p(rots), n,
                               opacity_threshold, _u8p(out))
        return out[:32 * cnt].tobytes()
    import tempfile

    from ..utils.gs_io import export_splat

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scene.splat")
        export_splat(path, (xyz[None], feats.reshape(1, n, 1, 3),
                            opacity.reshape(1, n, 1), scales[None],
                            rots[None]), opacity_threshold)
        with open(path, "rb") as fp:
            return fp.read()
