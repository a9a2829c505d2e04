"""Camera-trajectory visualisation (``prometheus_tpu/utils/
visualization.py``) without plotting packages: frustum wireframes as a
line-segment ``.ply`` (opens in any 3D viewer beside the gaussians' ``.ply``),
a self-contained HTML gallery, and a top-down orthographic PNG of the frusta
(through PIL) for training snapshots. Cameras are 18-dim numpy vectors.
"""
from __future__ import annotations

import numpy as np


def frustum_corners(camera: np.ndarray, depth: float = 0.3) -> np.ndarray:
    """18-dim camera vector -> (5, 3) apex + 4 image-plane corners (world)."""
    c2w = np.eye(4)
    c2w[:3] = np.asarray(camera[:12]).reshape(3, 4)
    fx, fy, cx, cy, H, W = camera[12:18]
    corners_px = np.asarray([[0, 0], [W, 0], [W, H], [0, H]], np.float64)
    x = (corners_px[:, 0] - cx) / fx
    y = -(corners_px[:, 1] - cy) / fy
    dirs = np.stack([x, y, -np.ones(4)], -1) * depth
    pts = dirs @ c2w[:3, :3].T + c2w[:3, 3]
    return np.concatenate([c2w[None, :3, 3], pts], axis=0)


_EDGES = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]


def export_cameras_ply(path: str, cameras: np.ndarray, depth: float = 0.3,
                       color=(255, 64, 64)) -> str:
    """Write all camera frusta as a wireframe .ply (vertices + edges)."""
    cameras = np.asarray(cameras)
    if cameras.ndim == 3:
        cameras = cameras[0]
    verts, edges = [], []
    for i, cam in enumerate(cameras):
        base = len(verts)
        verts.extend(frustum_corners(cam, depth))
        edges.extend([(base + a, base + b) for a, b in _EDGES])
    verts = np.asarray(verts, np.float32)
    if not path.endswith(".ply"):
        path += ".ply"
    with open(path, "wb") as fp:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            f"element edge {len(edges)}\n"
            "property int vertex1\nproperty int vertex2\n"
            "end_header\n"
        )
        fp.write(header.encode("ascii"))
        col = np.tile(np.asarray(color, np.uint8), (len(verts), 1))
        rec = np.empty(len(verts),
                       dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
        rec["xyz"], rec["rgb"] = verts, col
        fp.write(rec.tobytes())
        fp.write(np.asarray(edges, "<i4").tobytes())
    return path


def write_html_gallery(path: str, entries: list[dict],
                       title: str = "prometheus-tpu gallery") -> str:
    """Self-contained HTML gallery (the reference's html visualizer analog).

    ``entries``: [{"title": ..., "images": [relative paths], "video": ...}].
    """
    rows = []
    for e in entries:
        imgs = "".join(
            f'<img src="{p}" loading="lazy">' for p in e.get("images", []))
        vid = (f'<video src="{e["video"]}" controls loop muted></video>'
               if e.get("video") else "")
        rows.append(
            f'<div class="row"><h3>{e.get("title", "")}</h3>'
            f'<div class="media">{imgs}{vid}</div></div>')
    html = f"""<!doctype html><html><head><meta charset="utf-8">
<title>{title}</title><style>
body{{font-family:sans-serif;background:#111;color:#eee;margin:2rem}}
.row{{margin-bottom:2rem}} .media{{display:flex;gap:8px;flex-wrap:wrap}}
img,video{{max-height:260px;border-radius:6px}}
h3{{margin:0 0 .5rem 0;font-weight:500}}
</style></head><body><h1>{title}</h1>{''.join(rows)}</body></html>"""
    with open(path, "w") as fp:
        fp.write(html)
    return path


def plot_cameras_png(path: str, cameras: np.ndarray, size: int = 512,
                     depth: float = 0.3) -> str:
    """Orthographic top-down (xz) projection of frusta as a quick PNG."""
    from PIL import Image, ImageDraw

    cameras = np.asarray(cameras)
    if cameras.ndim == 3:
        cameras = cameras[0]
    all_pts = np.concatenate([frustum_corners(c, depth) for c in cameras])
    lo = all_pts.min(0) - 0.2
    hi = all_pts.max(0) + 0.2
    span = max(float((hi - lo)[[0, 2]].max()), 1e-3)

    def to_px(p):
        return (int((p[0] - lo[0]) / span * (size - 20)) + 10,
                int((p[2] - lo[2]) / span * (size - 20)) + 10)

    img = Image.new("RGB", (size, size), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    for i, cam in enumerate(cameras):
        pts = frustum_corners(cam, depth)
        hue = int(200 * i / max(len(cameras) - 1, 1))
        color = (55 + hue, 80, 255 - hue)
        for a, b in _EDGES:
            draw.line([to_px(pts[a]), to_px(pts[b])], fill=color, width=1)
    img.save(path)
    return path
