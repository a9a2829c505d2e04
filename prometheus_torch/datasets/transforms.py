"""Image transforms of the data pipeline (``prometheus_tpu/datasets/
transforms.py``), host-side.

Decode, central-square crop, antialiased resize, normalisation to float32
CHW in [-1, 1], flips and the augmentations. The pixel intrinsics ``[fx,
fy, cx, cy]`` are adjusted alongside every crop and resize, so the 18-dim
camera vector stays consistent with its image. As in the JAX package, the
per-frame training transform (``crop_resize_normalize``,
``decode_crop_resize_normalize``) runs through the native data plane
(``prometheus_torch.native``: libjpeg's DCT-downscaled decode fused with
a C++ triangle-filter resize); ``PROMETHEUS_NATIVE=0`` takes the PIL
(LANCZOS) and numpy path instead, and ``PROMETHEUS_JPEG_DRAFT=0`` decodes
JPEGs at full size on either path.
"""
from __future__ import annotations

import io
import os

import numpy as np
from PIL import Image


def decode_image(data: bytes) -> np.ndarray:
    """bytes -> (H, W, 3) uint8 RGB."""
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def decode_image_draft(data: bytes, target: int):
    """Decode for a ``target``^2 training frame. A JPEG decodes at the
    largest libjpeg DCT downscale (1/2, 1/4, 1/8) that keeps its short side
    >= ``target`` (PIL's draft mode), so the resize after it still strictly
    downsamples; other formats, and ``PROMETHEUS_JPEG_DRAFT=0``, decode at
    full size.

    Returns ``(arr, (sx, sy))`` with ``sx = decoded_w / original_w`` (and
    ``sy`` likewise): multiply full-resolution pixel intrinsics ``[fx, cx]``
    by ``sx`` and ``[fy, cy]`` by ``sy`` before the crop's adjustment."""
    img = Image.open(io.BytesIO(data))
    w, h = img.size
    if (img.format == "JPEG" and target > 0
            and os.environ.get("PROMETHEUS_JPEG_DRAFT", "1") != "0"):
        k = 1
        while k < 8 and min(w, h) // (2 * k) >= target:
            k *= 2
        if k > 1:
            img.draft("RGB", (w // k, h // k))
    arr = np.asarray(img.convert("RGB"))
    return arr, (arr.shape[1] / w, arr.shape[0] / h)


def _adjust_intrinsics(intr, h: int, w: int, size: int) -> np.ndarray:
    """Pixel intrinsics at (h, w) -> after the central-square crop and the
    resize to ``size``^2."""
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    fx, fy, cx, cy = intr
    scale = size / s
    return np.asarray([fx * scale, fy * scale,
                       (cx - left) * scale, (cy - top) * scale], np.float32)


def center_crop_and_resize(img: np.ndarray, size: int,
                           intrinsics: np.ndarray | None = None):
    """Crop the central square of uint8 HWC ``img`` and resize it to
    ``size``^2 (LANCZOS). Returns ``(img, intrinsics)``, the intrinsics
    adjusted (a new array) when given."""
    h, w = img.shape[:2]
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    img = img[top:top + s, left:left + s]
    out = np.asarray(Image.fromarray(img).resize(
        (size, size), Image.Resampling.LANCZOS))
    if intrinsics is not None:
        intrinsics = _adjust_intrinsics(intrinsics, h, w, size)
    return out, intrinsics


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 (3, H, W) in [-1, 1]."""
    return np.moveaxis(img.astype(np.float32) / 127.5 - 1.0, -1, 0)


def crop_resize_normalize(img: np.ndarray, size: int,
                          intrinsics: np.ndarray | None = None):
    """The per-frame training transform: central-square crop, antialiased
    resize, float32 CHW in [-1, 1], in one pass of the native data plane
    (its PIL LANCZOS + numpy version under ``PROMETHEUS_NATIVE=0``).
    Returns ``(chw, intrinsics)``."""
    from .. import native

    if intrinsics is not None:
        h, w = img.shape[:2]
        intrinsics = _adjust_intrinsics(intrinsics, h, w, size)
    return native.center_crop_resize_normalize(img, size), intrinsics


def _scale_intrinsics(intrinsics, normalized: bool, sx: float, sy: float,
                      dh: int, dw: int) -> np.ndarray:
    """Full-resolution pixel (or normalized) intrinsics -> the decoded
    image's pixels."""
    fx, fy, cx, cy = np.asarray(intrinsics, np.float32)
    if normalized:
        return np.asarray([fx * dw, fy * dh, cx * dw, cy * dh], np.float32)
    return np.asarray([fx * sx, fy * sy, cx * sx, cy * sy], np.float32)


def decode_crop_resize_normalize(data: bytes, size: int,
                                 intrinsics: np.ndarray | None = None,
                                 normalized: bool = False):
    """Image bytes -> (DCT-downscaled) decode -> crop -> resize -> float32
    CHW in [-1, 1], with the intrinsics ``[fx, fy, cx, cy]`` given in
    full-resolution pixels (``normalized=False``) or as ``[fx/W, fy/H, cx/W,
    cy/H]`` (``normalized=True``) and returned in ``size``^2 pixels.

    A JPEG goes through the native library in one call (libjpeg decode
    fused with the transform); other formats, a file libjpeg declines, a
    library built without libjpeg and ``PROMETHEUS_NATIVE=0`` decode with
    PIL (:func:`decode_image_draft`) and go on through
    :func:`crop_resize_normalize`."""
    from .. import native

    max_denom = (1 if os.environ.get("PROMETHEUS_JPEG_DRAFT", "1") == "0"
                 else 8)
    out = native.decode_jpeg_crop_resize_normalize(data, size, max_denom)
    if out is not None:
        chw, (sx, sy), (dh, dw) = out
        if intrinsics is not None:
            intrinsics = _adjust_intrinsics(_scale_intrinsics(
                intrinsics, normalized, sx, sy, dh, dw), dh, dw, size)
        return chw, intrinsics
    raw, (sx, sy) = decode_image_draft(data, size)
    dh, dw = raw.shape[:2]
    if intrinsics is not None:
        intrinsics = _scale_intrinsics(intrinsics, normalized, sx, sy, dh, dw)
    return crop_resize_normalize(raw, size, intrinsics)


def hflip(img: np.ndarray) -> np.ndarray:
    return img[:, ::-1].copy()


def hflip_camera(camera: np.ndarray) -> np.ndarray:
    """Mirror an 18-dim camera for a horizontal image flip: negate the
    pose's first column and mirror ``cx``."""
    cam = camera.copy()
    c2w = cam[:12].reshape(3, 4)
    c2w[:, 0] *= -1
    cam[:12] = c2w.reshape(-1)
    cam[14] = cam[17] - cam[14]  # cx' = W - cx
    return cam


def jpeg_compress(img: np.ndarray, quality: int = 75) -> np.ndarray:
    """JPEG round-trip augmentation (uint8 HWC)."""
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    buf.seek(0)
    return np.asarray(Image.open(buf).convert("RGB"))


def random_crop_and_resize(img: np.ndarray, size: int, rng,
                           min_scale: float = 0.6,
                           intrinsics: np.ndarray | None = None):
    """A random square crop (side in [min_scale, 1] of the short side) and
    a LANCZOS resize, with the intrinsics adjusted; ``rng`` is a
    ``random.Random``."""
    h, w = img.shape[:2]
    s = min(h, w)
    crop = int(s * (min_scale + (1.0 - min_scale) * rng.random()))
    top = rng.randrange(max(h - crop, 0) + 1)
    left = rng.randrange(max(w - crop, 0) + 1)
    patch = img[top:top + crop, left:left + crop]
    out = np.asarray(Image.fromarray(patch).resize(
        (size, size), Image.Resampling.LANCZOS))
    if intrinsics is not None:
        fx, fy, cx, cy = intrinsics
        scale = size / crop
        intrinsics = np.asarray([fx * scale, fy * scale, (cx - left) * scale,
                                 (cy - top) * scale], np.float32)
    return out, intrinsics


def adjust_hsv(img: np.ndarray, dh: float = 0.0, ds: float = 0.0,
               dv: float = 0.0) -> np.ndarray:
    """Hue shift (a fraction of the circle) and saturation / value scale
    offsets of uint8 HWC ``img``."""
    hsv = np.asarray(Image.fromarray(img).convert("HSV")).astype(np.int16)
    hsv[..., 0] = (hsv[..., 0] + int(dh * 255)) % 256
    hsv[..., 1] = np.clip(hsv[..., 1] * (1.0 + ds), 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] * (1.0 + dv), 0, 255)
    return np.asarray(
        Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB"))


def gaussian_blur(img: np.ndarray, radius: float = 1.0) -> np.ndarray:
    from PIL import ImageFilter

    return np.asarray(Image.fromarray(img).filter(
        ImageFilter.GaussianBlur(radius)))
