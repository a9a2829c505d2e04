"""Image and video export (``prometheus_tpu/utils/image.py``), numpy arrays.

``save_image`` writes PNG with the standard library alone (``zlib`` and
``struct``), so the exports need no imaging package; the pixels decode
bit-equal to the JAX writer's. ``load_image`` reads through PIL,
``save_gif`` writes an animated GIF through PIL, ``ImageGrid`` composes
snapshot grids (resizing through PIL), and ``save_video`` writes mp4 through
imageio or, failing that, a GIF through PIL; each imports its package when
called.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

# A compact Spectral_r-like colormap (matplotlib's Spectral reversed),
# 11 anchor colours, linearly interpolated.
_SPECTRAL_R = np.asarray([
    (94, 79, 162), (50, 136, 189), (102, 194, 165), (171, 221, 164),
    (230, 245, 152), (255, 255, 191), (254, 224, 139), (253, 174, 97),
    (244, 109, 67), (213, 62, 79), (158, 1, 66),
], np.float32) / 255.0

# PNG colour type by channel count: grey, RGB, RGBA
_PNG_COLOR_TYPE = {1: 0, 3: 2, 4: 6}


def postprocess_image(img, lo: float = -1.0, hi: float = 1.0) -> np.ndarray:
    """(…, 3, H, W) in [lo, hi] -> uint8 (…, H, W, 3)."""
    arr = np.asarray(img, np.float32)
    arr = (arr - lo) / (hi - lo)
    arr = np.clip(arr, 0.0, 1.0)
    arr = np.moveaxis(arr, -3, -1)
    return (arr * 255).round().astype(np.uint8)


def colorize_depth(depth, lo: float | None = None, hi: float | None = None,
                   cmap: np.ndarray = _SPECTRAL_R) -> np.ndarray:
    """(…, H, W) depth or disparity -> uint8 (…, H, W, 3) colour-mapped."""
    d = np.asarray(depth, np.float32)
    lo = float(d.min()) if lo is None else lo
    hi = float(d.max()) if hi is None else hi
    t = np.clip((d - lo) / max(hi - lo, 1e-8), 0.0, 1.0)
    x = t * (len(cmap) - 1)
    i0 = np.floor(x).astype(np.int32)
    i1 = np.minimum(i0 + 1, len(cmap) - 1)
    frac = (x - i0)[..., None]
    rgb = cmap[i0] * (1 - frac) + cmap[i1] * frac
    return (rgb * 255).round().astype(np.uint8)


def make_grid(images: np.ndarray, cols: int | None = None,
              pad: int = 2, pad_value: int = 255) -> np.ndarray:
    """(N, H, W, 3) uint8 -> one tiled grid image."""
    n, h, w, c = images.shape
    cols = cols or int(np.ceil(np.sqrt(n)))
    rows = -(-n // cols)
    grid = np.full((rows * (h + pad) - pad, cols * (w + pad) - pad, c),
                   pad_value, np.uint8)
    for i in range(n):
        r, cc = divmod(i, cols)
        grid[r * (h + pad): r * (h + pad) + h,
             cc * (w + pad): cc * (w + pad) + w] = images[i]
    return grid


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save_image(arr: np.ndarray, path: str) -> None:
    """uint8 ``(H, W)``, ``(H, W, 3)`` or ``(H, W, 4)`` -> an 8-bit PNG
    (every row unfiltered, zlib level 6)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
                 + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                 + _png_chunk(b"IEND", b""))


def load_image(path: str) -> np.ndarray:
    """PNG or JPEG -> uint8 (H, W, 3), through PIL."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def save_video(frames: np.ndarray, path: str, fps: int = 30) -> str:
    """(T, H, W, 3) uint8 -> mp4 through imageio or, where imageio is
    missing or cannot write it, an animated GIF beside it through PIL.
    Returns the path written; raises when neither package is installed."""
    try:
        import imageio.v3 as iio

        iio.imwrite(path, frames, fps=fps)
        return path
    except Exception as e:       # no imageio, or no mp4 writer in it
        cause = e
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "save_video needs imageio (mp4) or PIL (GIF); imageio failed "
            f"({cause!r}) and PIL is not installed") from e
    gif = path.rsplit(".", 1)[0] + ".gif"
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(gif, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    return gif


def save_gif(frames, path: str, duration_ms: int = 100, loop: int = 0,
             size: tuple[int, int] | None = None) -> str:
    """Frames (uint8 ``(H, W, 3)``) -> an animated GIF, each frame resized
    (LANCZOS) to ``size = (height, width)`` when given. Returns ``path``."""
    from PIL import Image

    imgs = []
    for f in frames:
        im = Image.fromarray(np.asarray(f, np.uint8))
        if size is not None and im.size != (size[1], size[0]):
            im = im.resize((size[1], size[0]), Image.LANCZOS)
        imgs.append(im)
    imgs[0].save(path, format="GIF", save_all=True, append_images=imgs[1:],
                 duration=duration_ms, loop=loop)
    return path


class ImageGrid:
    """A cell-addressable grid of images with spacing and a background
    value. Cells take the size of the first image added; later images are
    resized (LANCZOS) to it.

        grid = ImageGrid(num_rows, num_cols, spacing=2)
        grid.add(i, j, image)       # uint8 (H, W, 3)
        grid.save("snap.png")       # or: arr = grid.compose()
    """

    def __init__(self, num_rows: int, num_cols: int, spacing: int = 0,
                 background: int = 255,
                 cell_size: tuple[int, int] | None = None):
        assert num_rows > 0 and num_cols > 0
        self.num_rows, self.num_cols = num_rows, num_cols
        self.spacing, self.background = spacing, background
        self.cell_size = cell_size
        self._cells: dict[tuple[int, int], np.ndarray] = {}

    def add(self, row: int, col: int, image) -> None:
        assert 0 <= row < self.num_rows and 0 <= col < self.num_cols
        arr = np.asarray(image, np.uint8)
        assert arr.ndim == 3 and arr.shape[-1] == 3, arr.shape
        if self.cell_size is None:
            self.cell_size = arr.shape[:2]
        if tuple(arr.shape[:2]) != tuple(self.cell_size):
            from PIL import Image

            arr = np.asarray(Image.fromarray(arr).resize(
                (self.cell_size[1], self.cell_size[0]), Image.LANCZOS))
        self._cells[(row, col)] = arr

    def compose(self) -> np.ndarray:
        assert self.cell_size is not None, "empty grid"
        h, w = self.cell_size
        s = self.spacing
        out = np.full((self.num_rows * (h + s) - s,
                       self.num_cols * (w + s) - s, 3), self.background,
                      np.uint8)
        for (r, c), img in self._cells.items():
            out[r * (h + s):r * (h + s) + h, c * (w + s):c * (w + s) + w] = img
        return out

    def save(self, path: str) -> str:
        save_image(self.compose(), path)
        return path
