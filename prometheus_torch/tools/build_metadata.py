"""Build dataset annotation files for the annotated-scene datasets (the
counterpart of the repo's ``tools/build_metadata.py``, with the same
subcommands, arguments and output files).

DL3DV pkl annotations, MVImgNet / COLMAP conversion, the RE10K
``index.json``, UrbanGen, CO3D (and its proxy depths), blender renders,
T2I caption sidecars and JourneyDB CSV shards: one CLI with a subcommand
per format, written in numpy, whose output is what
``prometheus_torch.datasets`` reads. Examples::

    python -m prometheus_torch.tools.build_metadata scan-scenes \
        --root data/dl3dv --out data/dl3dv/annotation.pkl
    python -m prometheus_torch.tools.build_metadata re10k-index \
        --root data/re10k/train
    python -m prometheus_torch.tools.build_metadata colmap \
        --root data/mvimgnet/scene0 --out scene0.pkl
"""
from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np


def scan_scenes(root: str, out: str, image_ext: str = ".jpg"):
    """Scan ``root/<scene>/`` directories holding frames + transforms.json
    (nerfstudio-style) into the annotation dict format."""
    ann = {}
    for scene in sorted(os.listdir(root)):
        sdir = os.path.join(root, scene)
        tpath = os.path.join(sdir, "transforms.json")
        if not os.path.isdir(sdir) or not os.path.exists(tpath):
            continue
        with open(tpath) as fp:
            meta = json.load(fp)
        frames, poses = [], []
        for fr in meta.get("frames", []):
            frames.append(os.path.join(scene, fr["file_path"]))
            poses.append(np.asarray(fr["transform_matrix"])[:3])
        if not frames:
            continue
        fx = meta.get("fl_x", meta.get("fx"))
        fy = meta.get("fl_y", meta.get("fy", fx))
        cx, cy = meta.get("cx"), meta.get("cy")
        ann[scene] = {
            "frames": frames,
            "poses": np.stack(poses).tolist(),
            "intrinsics": [fx, fy, cx, cy],
            "captions": meta.get("captions", []),
        }
    with open(out, "wb") as fp:
        pickle.dump(ann, fp)
    print(f"[metadata] {len(ann)} scenes -> {out}")


def re10k_index(root: str):
    """Index pixelsplat-style .torch chunks: scene key -> chunk file."""
    import torch

    index = {}
    for name in sorted(os.listdir(root)):
        if not name.endswith(".torch"):
            continue
        chunk = torch.load(os.path.join(root, name), map_location="cpu",
                           weights_only=True)
        if isinstance(chunk, dict):
            chunk = [chunk]
        for entry in chunk:
            index[entry["key"]] = name
    out = os.path.join(root, "index.json")
    with open(out, "w") as fp:
        json.dump(index, fp)
    print(f"[metadata] {len(index)} scenes -> {out}")


# COLMAP camera-model id -> (name, param count); binary files store the id
# (github.com/colmap/colmap src/colmap/sensor/models.h — public format spec)
_COLMAP_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def _intrinsics_of(model: str, p: list[float]) -> list[float]:
    if model.startswith("SIMPLE_") or model in ("RADIAL", "FOV",
                                                "RADIAL_FISHEYE"):
        return [p[0], p[0], p[1], p[2]]  # f, cx, cy (+distortion ignored)
    return [p[0], p[1], p[2], p[3]]      # fx, fy, cx, cy


def _read_colmap_model(root: str):
    """Read a COLMAP sparse model, text OR binary, from ``root`` (or its
    ``sparse/0`` subdir). Returns ``(cams {id: [fx fy cx cy]}, images
    [(name, qwxyz, tvec, cam_id)])`` sorted by image name.

    MVImgNet and most COLMAP pipelines ship the BINARY model
    (cameras.bin/images.bin) — the reference reads it through LLFF's
    pose_utils (``tools/mvimagenet/generate_cameras.py:19``); this is a
    dependency-free reader of the documented format.
    """
    import struct

    for cand in (root, os.path.join(root, "sparse", "0"),
                 os.path.join(root, "sparse")):
        if os.path.exists(os.path.join(cand, "cameras.txt")) or \
                os.path.exists(os.path.join(cand, "cameras.bin")):
            root = cand
            break

    cams = {}
    if os.path.exists(os.path.join(root, "cameras.bin")):
        with open(os.path.join(root, "cameras.bin"), "rb") as fp:
            n_cams, = struct.unpack("<Q", fp.read(8))
            for _ in range(n_cams):
                cam_id, model_id = struct.unpack("<ii", fp.read(8))
                _w, _h = struct.unpack("<QQ", fp.read(16))
                name, n_par = _COLMAP_MODELS[model_id]
                p = list(struct.unpack(f"<{n_par}d", fp.read(8 * n_par)))
                cams[cam_id] = _intrinsics_of(name, p)
    else:
        with open(os.path.join(root, "cameras.txt")) as fp:
            for line in fp:
                if line.startswith("#") or not line.strip():
                    continue
                parts = line.split()
                cam_id, model = int(parts[0]), parts[1]
                p = list(map(float, parts[4:]))
                cams[cam_id] = _intrinsics_of(model, p)

    images = []
    if os.path.exists(os.path.join(root, "images.bin")):
        with open(os.path.join(root, "images.bin"), "rb") as fp:
            n_imgs, = struct.unpack("<Q", fp.read(8))
            for _ in range(n_imgs):
                img_id, = struct.unpack("<i", fp.read(4))
                q = struct.unpack("<4d", fp.read(32))
                t = struct.unpack("<3d", fp.read(24))
                cam_id, = struct.unpack("<i", fp.read(4))
                name = b""
                while (c := fp.read(1)) != b"\x00":
                    name += c
                n_pts, = struct.unpack("<Q", fp.read(8))
                fp.seek(24 * n_pts, 1)  # (x, y, point3D_id) per point
                images.append((name.decode(), list(q), list(t), cam_id))
    else:
        with open(os.path.join(root, "images.txt")) as fp:
            lines = [ln for ln in fp
                     if not ln.startswith("#") and ln.strip()]
        for ln in lines[::2]:  # every other line is 2D points
            parts = ln.split()
            images.append((parts[9], list(map(float, parts[1:5])),
                           list(map(float, parts[5:8])), int(parts[8])))
    images.sort(key=lambda it: it[0])
    return cams, images


def _colmap_scene_entry(root: str, frame_prefix: str = ""):
    """One scene's COLMAP model -> annotation entry dict."""
    import torch

    from ..utils.quaternion import quaternion_to_matrix

    cams, images = _read_colmap_model(root)
    frames, poses, intr = [], [], []
    for name, q, t, cam_id in images:
        R = quaternion_to_matrix(torch.tensor(q)).numpy()
        # COLMAP stores world->cam; invert to c2w (OpenCV), datasets convert
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = t
        poses.append(np.linalg.inv(w2c)[:3])
        frames.append(os.path.join(frame_prefix, name) if frame_prefix
                      else name)
        intr.append(cams[cam_id])
    return {"frames": frames, "poses": np.stack(poses).tolist(),
            "intrinsics": intr, "captions": []}


def colmap_to_annotation(root: str, out: str):
    """Convert one COLMAP export (text or binary) to annotations."""
    scene = os.path.basename(root.rstrip("/"))
    ann = {scene: _colmap_scene_entry(root)}
    with open(out, "wb") as fp:
        pickle.dump(ann, fp)
    print(f"[metadata] {len(ann[scene]['frames'])} frames ({scene}) -> {out}")


def mvimgnet_annotations(root: str, out: str, category: str = "all"):
    """MVImgNet: walk ``<root>/<category>/<scene>/sparse/0`` COLMAP models
    into ONE annotation pickle; frames point at ``<category>/<scene>/images``.

    Reference analog: ``tools/mvimagenet/generate_cameras.py`` (LLFF
    pose_utils over per-scene COLMAP) + ``build_metadata.py`` (merge).
    """
    cats = sorted(os.listdir(root)) if category == "all" else [category]
    ann, bad = {}, 0
    for cat in cats:
        cdir = os.path.join(root, cat)
        if not os.path.isdir(cdir):
            continue
        for scene in sorted(os.listdir(cdir)):
            sdir = os.path.join(cdir, scene)
            if not os.path.isdir(sdir):
                continue
            try:
                prefix = (os.path.join(cat, scene, "images")
                          if os.path.isdir(os.path.join(sdir, "images"))
                          else os.path.join(cat, scene))
                ann[f"{cat}/{scene}"] = _colmap_scene_entry(
                    sdir, frame_prefix=prefix)
            except (OSError, KeyError, ValueError) as e:
                bad += 1
                print(f"[metadata] skip {cat}/{scene}: {e}")
    with open(out, "wb") as fp:
        pickle.dump(ann, fp)
    print(f"[metadata] mvimgnet: {len(ann)} scenes -> {out} ({bad} skipped)")


def journeydb_csv(raw_csv: str, out_dir: str, shard_size: int = 100000,
                  mode: str = "full", image_root: str | None = None):
    """Reshard JourneyDB's raw caption CSV into the
    ``filenames_and_captions_{mode}_{i}.csv`` shards ``Text2ImageDataset``
    ingests ([Image Name, Image Path, Caption] rows).

    Reference analog: ``tools/journeydb/build_metadata.py:60-105`` —
    including its path rewrite (drop the first two path components) and the
    optional existence filter (its ``local_tiny`` mode).
    """
    import csv

    meta_dir = os.path.join(out_dir, "metadata")
    os.makedirs(meta_dir, exist_ok=True)
    shard, rows, n_total, skipped = 0, [], 0, 0

    def flush():
        nonlocal shard, rows
        if not rows:
            return
        path = os.path.join(meta_dir,
                            f"filenames_and_captions_{mode}_{shard}.csv")
        with open(path, "w", encoding="utf-8", newline="") as fp:
            w = csv.writer(fp)
            w.writerow(["Image Name", "Image Path", "Caption"])
            w.writerows(rows)
        shard += 1
        rows = []

    with open(raw_csv, encoding="utf-8") as fp:
        reader = csv.reader(fp)
        for i, line in enumerate(reader):
            if i == 0 or not line:
                continue
            parts = line[0].split("/")
            rel = "/".join(parts[2:]) if len(parts) > 2 else line[0]
            if image_root and not os.path.exists(
                    os.path.join(image_root, rel)):
                skipped += 1
                continue
            rows.append([parts[-1], rel, line[-1]])
            n_total += 1
            if len(rows) >= shard_size:
                flush()
    flush()
    print(f"[metadata] journeydb: {n_total} rows -> {shard} shard(s) in "
          f"{meta_dir} ({skipped} missing-image rows skipped)")


def dl3dv_raw(root: str, out: str, require_caption: bool = False):
    """Ingest the raw DL3DV-10K layout into the annotation format.

    Raw layout (reference ``dl3dv10k_dataset.py:63-118``): hash-named scene
    dirs with nerfstudio ``transforms.json`` (``applied_transform`` affine,
    distortion params), downsampled frames under ``images_4/``, and optional
    per-scene ``captions.txt``.
    """
    ann, skipped = {}, 0
    for scene in sorted(os.listdir(root)):
        sdir = os.path.join(root, scene)
        tpath = os.path.join(sdir, "transforms.json")
        if not os.path.isdir(sdir) or not os.path.exists(tpath):
            continue
        with open(tpath) as fp:
            meta = json.load(fp)
        affine = np.asarray(meta.get("applied_transform",
                                     np.eye(4)[:3].tolist()), np.float64)
        frames, poses = [], []
        for fr in meta.get("frames", []):
            name = os.path.basename(fr["file_path"])
            rel = os.path.join(scene, "images_4", name)
            if not os.path.exists(os.path.join(root, rel)):
                rel = os.path.join(scene, fr["file_path"])
                if not os.path.exists(os.path.join(root, rel)):
                    continue
            c2w = np.asarray(fr["transform_matrix"], np.float64)
            c2w34 = affine @ c2w  # nerfstudio -> OpenGL (reference :152)
            frames.append(rel)
            poses.append(c2w34[:3] if c2w34.shape[0] == 4 else c2w34)
        if not frames:
            skipped += 1
            continue
        # images_4 frames are 4x downsampled relative to transforms.json
        h_meta = float(meta.get("h", 0)) or None
        fx, fy = meta.get("fl_x"), meta.get("fl_y", meta.get("fl_x"))
        cx, cy = meta.get("cx"), meta.get("cy")
        if h_meta:
            from PIL import Image

            with Image.open(os.path.join(root, frames[0])) as im:
                scale = im.height / h_meta
            fx, fy, cx, cy = (v * scale for v in (fx, fy, cx, cy))
        captions = []
        cpath = os.path.join(sdir, "captions.txt")
        if os.path.exists(cpath):
            with open(cpath, encoding="utf-8") as fp:
                captions = [ln.strip() for ln in fp if ln.strip()]
        if require_caption and not captions:
            skipped += 1
            continue
        ann[scene] = {"frames": frames,
                      "poses": np.stack(poses).tolist(),
                      "intrinsics": [fx, fy, cx, cy],
                      "captions": captions}
    with open(out, "wb") as fp:
        pickle.dump(ann, fp)
    print(f"[metadata] dl3dv: {len(ann)} scenes ({skipped} skipped) -> {out}")


def urbangen_pkl(ann_path: str, out: str):
    """Convert the UrbanGen annotation pkl into the annotation format.

    Source layout (reference ``urban_dataset.py:112-140``): ``{scene_name:
    [ {image_path, cam2world (4,4), cam_K (3,3)}, ... ]}`` with scene names
    prefixed by their subdataset (``kitti360_...``, ``nuscenes_...``,
    ``waymo_...``); poses are OpenCV c2w. Frame paths stay relative to the
    zip/dir root the dataset's file reader is pointed at.
    """
    with open(ann_path, "rb") as fp:
        src = pickle.load(fp)
    ann = {}
    for scene, frames_meta in src.items():
        frames, poses, intr = [], [], []
        for fm in frames_meta:
            K = np.asarray(fm["cam_K"], np.float64)
            frames.append(fm["image_path"])
            poses.append(np.asarray(fm["cam2world"], np.float64)[:3])
            intr.append([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
        if not frames:
            continue
        ann[scene] = {"frames": frames,
                      "poses": np.stack(poses).tolist(),
                      "intrinsics": intr,
                      "subdataset": scene.split("_")[0],
                      "captions": []}
    with open(out, "wb") as fp:
        pickle.dump(ann, fp)
    print(f"[metadata] urbangen: {len(ann)} scenes -> {out}")


def co3d_annotations(root: str, out: str, categories: list | None = None):
    """CO3D ``frame_annotations.jgz`` -> generic annotation format.

    Replaces the reference legacy CO3D path (``datasets/legacy/co3d.py``
    built on pytorch3d's JsonIndexDataset + the ~2k-LoC proxy-depth tools):
    the jgz is plain gzipped JSON, parsed directly. pytorch3d NDC cameras
    are converted to OpenCV-pixel c2w following pytorch3d's own
    ``opencv_from_cameras_projection`` (flip the first two columns of R and
    first two components of T, transpose; focal/principal scaled by
    ``min(H, W)/2``).
    """
    import gzip

    cats = categories or [d for d in sorted(os.listdir(root))
                          if os.path.isfile(os.path.join(
                              root, d, "frame_annotations.jgz"))]
    ann = {}
    for cat in cats:
        path = os.path.join(root, cat, "frame_annotations.jgz")
        with gzip.open(path, "rt") as fp:
            frames_meta = json.load(fp)
        seqs: dict[str, list] = {}
        for fm in frames_meta:
            seqs.setdefault(fm["sequence_name"], []).append(fm)
        for seq, fms in seqs.items():
            frames, poses, intr = [], [], []
            for fm in sorted(fms, key=lambda f: f.get("frame_number", 0)):
                vp = fm.get("viewpoint")
                img = fm.get("image", {})
                if vp is None or "path" not in img:
                    continue
                H, W = img["size"]
                s = min(H, W) / 2.0
                R = np.asarray(vp["R"], np.float64)         # pytorch3d row-major
                T = np.asarray(vp["T"], np.float64)
                R = R.copy()
                R[:, :2] *= -1.0
                T = T.copy()
                T[:2] *= -1.0
                R_cv = R.T                                   # w2c rotation
                c2w_R = R_cv.T
                c2w_t = -R_cv.T @ T
                fx = vp["focal_length"][0] * s
                fy = vp["focal_length"][1] * s
                cx = W / 2.0 - vp["principal_point"][0] * s
                cy = H / 2.0 - vp["principal_point"][1] * s
                frames.append(img["path"])
                poses.append(np.concatenate(
                    [c2w_R, c2w_t[:, None]], axis=1).tolist())
                intr.append([fx, fy, cx, cy])
            if len(frames) >= 2:
                ann[f"{cat}/{seq}"] = {
                    "frames": frames, "poses": poses, "intrinsics": intr,
                    "captions": [cat.replace("_", " ")]}
    with open(out, "wb") as fp:
        pickle.dump(ann, fp)
    print(f"[metadata] co3d: {len(ann)} sequences -> {out}")


# ---------------------------------------------------------------------------
# CO3D proxy-depth generation (the analog of the reference's
# tools/co3d/get_proxy.py:987-1110 + get_coarse_depth.py: per-sequence
# pointcloud -> per-frame depth annotation for stage-1 training)
# ---------------------------------------------------------------------------

def read_ply_points(path: str) -> np.ndarray:
    """Minimal PLY vertex reader (ascii / binary_little_endian), xyz only —
    replaces the reference's trimesh.load (get_proxy.py:1056)."""
    with open(path, "rb") as fp:
        header = []
        while True:
            line = fp.readline().decode("ascii", "replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n = int(next(l.split()[2] for l in header
                     if l.startswith("element vertex")))
        types = {"float": ("f4", 4), "float32": ("f4", 4),
                 "double": ("f8", 8), "uchar": ("u1", 1),
                 "uint8": ("u1", 1), "int": ("i4", 4), "uint": ("u4", 4),
                 "short": ("i2", 2), "ushort": ("u2", 2)}
        props = []
        in_vertex = False
        for l in header:
            if l.startswith("element"):
                in_vertex = l.startswith("element vertex")
            elif l.startswith("property") and in_vertex:
                _, t, name = l.split()[:3]
                props.append((name, types[t][0]))
        if fmt == "ascii":
            rows = np.loadtxt(
                path, skiprows=len(header), max_rows=n, dtype=np.float64,
                usecols=range(len(props)))
            rows = np.atleast_2d(rows)
            idx = {name: i for i, (name, _) in enumerate(props)}
            return np.stack([rows[:, idx[a]] for a in "xyz"],
                            -1).astype(np.float32)
        dt = np.dtype([(name, t) for name, t in props])
        rows = np.frombuffer(fp.read(n * dt.itemsize), dtype=dt, count=n)
        return np.stack([rows[a].astype(np.float32) for a in "xyz"], -1)


def remove_outliers(points: np.ndarray, z_thresh: float = 2.0) -> np.ndarray:
    """Z-score outlier rejection (reference get_proxy.py:161-170)."""
    mean = points.mean(0)
    std = points.std(0, ddof=1) + 1e-12
    keep = (np.abs((points - mean) / std) < z_thresh).all(1)
    return points[keep]


def pca_obb(points: np.ndarray):
    """PCA oriented bounding box: (center, axes rows (3,3), half_sizes).

    The reference uses open3d's ``get_oriented_bounding_box``
    (get_proxy.py:356) — also a PCA-frame box; extents here come from the
    min/max of the points projected into the eigenframe."""
    mean = points.mean(0)
    cov = np.cov((points - mean).T)
    _, vecs = np.linalg.eigh(cov)
    axes = vecs.T                          # rows = box axes
    local = (points - mean) @ axes.T
    lo, hi = local.min(0), local.max(0)
    center = mean + ((lo + hi) / 2.0) @ axes
    half = (hi - lo) / 2.0
    return center.astype(np.float32), axes.astype(np.float32), \
        half.astype(np.float32)


def ray_box_depth(c2w: np.ndarray, fx, fy, cx, cy, H: int, W: int,
                  center, axes, half) -> np.ndarray:
    """Per-pixel z-depth of the first OBB intersection (slab method) —
    the analog of the reference's pytorch3d OBB-mesh depth render
    (get_proxy.py:202-247). 0 where the ray misses."""
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    d_cam = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], -1)
    R, t = c2w[:3, :3], c2w[:3, 3]
    d_world = d_cam @ R.T                      # unnormalized: t == z-depth
    o_local = (t - center) @ axes.T            # into the box frame
    d_local = d_world @ axes.T                 # (H, W, 3)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / d_local
        t0 = (-half - o_local) * inv
        t1 = (half - o_local) * inv
    tmin = np.minimum(t0, t1).max(-1)
    tmax = np.maximum(t0, t1).min(-1)
    hit = (tmax >= np.maximum(tmin, 0.0))
    entry = np.where(tmin > 0, tmin, tmax)     # camera inside box -> exit
    return np.where(hit, entry, 0.0).astype(np.float32)


def point_splat_depth(points: np.ndarray, w2c: np.ndarray, fx, fy, cx, cy,
                      H: int, W: int, splat: int = 1,
                      fill_iters: int = 16) -> np.ndarray:
    """Coarse z-buffer depth from the sequence point cloud — the analog of
    the reference's point-rasterized coarse depth (get_coarse_depth.py):
    nearest-point depth per pixel with a ``splat``-pixel footprint, holes
    filled by iterative neighborhood-min dilation. 0 where never covered."""
    pc = points @ w2c[:3, :3].T + w2c[:3, 3]
    z = pc[:, 2]
    front = z > 1e-6
    pc, z = pc[front], z[front]
    u = np.round(pc[:, 0] / z * fx + cx - 0.5).astype(np.int64)
    v = np.round(pc[:, 1] / z * fy + cy - 0.5).astype(np.int64)
    depth = np.full((H, W), np.inf, np.float32)
    for dv in range(-splat, splat + 1):
        for du in range(-splat, splat + 1):
            uu, vv = u + du, v + dv
            ok = (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
            np.minimum.at(depth, (vv[ok], uu[ok]), z[ok].astype(np.float32))
    for _ in range(fill_iters):
        holes = ~np.isfinite(depth)
        if not holes.any():
            break
        p = np.pad(depth, 1, constant_values=np.inf)
        neigh = np.stack([p[1:-1, :-2], p[1:-1, 2:], p[:-2, 1:-1],
                          p[2:, 1:-1]], 0).min(0)
        depth = np.where(holes, neigh, depth)
    return np.where(np.isfinite(depth), depth, 0.0)


def co3d_proxy_depth(root: str, annotation: str, out_dir: str,
                     mode: str = "obb", depth_size: int = 256,
                     categories: list | None = None):
    """Generate per-frame proxy depth for CO3D sequences.

    ``mode='obb'``: depth of the PCA oriented bounding box of the
    (outlier-rejected) sequence point cloud — the reference get_proxy.py
    pipeline. ``mode='points'``: hole-filled point-splat z-buffer — the
    get_coarse_depth.py flavor. Writes ``<out_dir>/<cat>/<seq>/<k>.npy``
    (fp16) and an updated annotation pkl (``<annotation>.depth.pkl``) whose
    entries gain a ``depths`` file list.
    """
    with open(annotation, "rb") as fp:
        ann = pickle.load(fp)
    n_done = 0
    for seq_key, meta in ann.items():
        if categories and seq_key.split("/")[0] not in categories:
            continue
        ply = os.path.join(root, seq_key, "pointcloud.ply")
        if not os.path.exists(ply):
            continue
        points = remove_outliers(read_ply_points(ply))
        if mode == "obb":
            center, axes, half = pca_obb(points)
        depths = []
        sdir = os.path.join(out_dir, seq_key)
        os.makedirs(sdir, exist_ok=True)
        for k, (pose, intr) in enumerate(zip(meta["poses"],
                                             meta["intrinsics"])):
            c2w = np.asarray(pose, np.float64)
            if c2w.shape == (3, 4):
                c2w = np.concatenate([c2w, [[0, 0, 0, 1]]], 0)
            fx, fy, cx, cy = intr
            # depth at a reduced working resolution (scaled intrinsics)
            Himg = int(2 * cy)
            Wimg = int(2 * cx)
            s = depth_size / max(Himg, Wimg, 1)
            H, W = max(int(round(Himg * s)), 1), max(int(round(Wimg * s)), 1)
            if mode == "obb":
                d = ray_box_depth(c2w, fx * s, fy * s, cx * s, cy * s,
                                  H, W, center, axes, half)
            elif mode == "points":
                w2c = np.linalg.inv(c2w)
                d = point_splat_depth(points, w2c, fx * s, fy * s,
                                      cx * s, cy * s, H, W)
            else:
                raise ValueError(mode)
            path = os.path.join(sdir, f"{k:05d}.npy")
            np.save(path, d.astype(np.float16))
            depths.append(os.path.relpath(path, out_dir))
        meta["depths"] = depths
        n_done += 1
    out_ann = annotation + ".depth.pkl"
    with open(out_ann, "wb") as fp:
        pickle.dump(ann, fp)
    print(f"[metadata] co3d-depth({mode}): {n_done} sequences -> {out_dir}; "
          f"annotation {out_ann}")


def blender_transforms(root: str, out: str, prompt_suffix: str = ""):
    """Blender/NeRF-synthetic object renders -> annotation format.

    Replaces the reference legacy ShapeNet/OmniObject3D readers
    (``datasets/legacy/{shapenet,omniobject3d}.py``): each scene dir holds
    ``transforms.json`` (or ``transforms_train.json``) with
    ``camera_angle_x`` + per-frame blender ``transform_matrix`` (already
    OpenGL-convention c2w).
    """
    ann = {}
    for scene in sorted(os.listdir(root)):
        sdir = os.path.join(root, scene)
        tf = None
        for name in ("transforms.json", "transforms_train.json"):
            if os.path.isfile(os.path.join(sdir, name)):
                with open(os.path.join(sdir, name)) as fp:
                    tf = json.load(fp)
                break
        if tf is None:
            continue
        frames, poses = [], []
        for fr in tf.get("frames", []):
            rel = fr["file_path"]
            if not os.path.splitext(rel)[1]:
                rel += ".png"
            frames.append(os.path.join(scene, rel))
            poses.append(np.asarray(
                fr["transform_matrix"], np.float64)[:3].tolist())
        if not frames:
            continue
        probe = os.path.join(root, frames[0])
        W = H = int(tf.get("w", tf.get("h", 0))) or None
        if W is None and os.path.isfile(probe):
            from PIL import Image

            with Image.open(probe) as im:
                W, H = im.size
        W, H = W or 800, H or 800
        fx = 0.5 * W / np.tan(0.5 * float(tf["camera_angle_x"]))
        caption = scene.replace("_", " ")
        if prompt_suffix:
            caption = f"{caption}, {prompt_suffix}"
        ann[scene] = {"frames": frames, "poses": poses,
                      "intrinsics": [[fx, fx, W / 2.0, H / 2.0]] * len(frames),
                      "captions": [caption]}
    with open(out, "wb") as fp:
        pickle.dump(ann, fp)
    print(f"[metadata] blender: {len(ann)} scenes -> {out}")


def t2i_captions(root: str, out: str, filelist: str | None = None):
    """SAM-1B / JourneyDB caption-sidecar layout -> T2I annotations.json.

    Reference analog: ``tools/sa1b/build_metadata.py`` /
    ``tools/journeydb/build_metadata.py`` — images listed in
    ``SAM_1B_filenames.txt`` (or discovered by glob) with captions at
    ``captions/<image stem>.txt``; the reference emits sharded CSVs, which
    ``Text2ImageDataset`` also consumes directly, so this converter is for
    building the compact json from the raw layout.
    """
    import glob

    names = None
    flist = filelist or os.path.join(root, "SAM_1B_filenames.txt")
    if os.path.isfile(flist):
        with open(flist, encoding="utf-8") as fp:
            names = [ln.strip() for ln in fp if ln.strip()]
    else:
        names = sorted(
            os.path.relpath(p, root)
            for p in glob.glob(os.path.join(root, "**", "*.jpg"),
                               recursive=True))
    items, skipped = [], 0
    for rel in names:
        stem = os.path.splitext(os.path.basename(rel))[0]
        cap_path = os.path.join(root, "captions", stem + ".txt")
        try:
            with open(cap_path, encoding="utf-8") as fp:
                caption = fp.read().strip()
        except OSError:
            skipped += 1
            continue
        items.append({"file": rel, "caption": caption})
    with open(out, "w", encoding="utf-8") as fp:
        json.dump(items, fp)
    print(f"[metadata] t2i-captions: {len(items)} images -> {out} "
          f"({skipped} without captions skipped)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    s1 = sub.add_parser("scan-scenes")
    s1.add_argument("--root", required=True)
    s1.add_argument("--out", required=True)
    s2 = sub.add_parser("re10k-index")
    s2.add_argument("--root", required=True)
    s3 = sub.add_parser("colmap")
    s3.add_argument("--root", required=True)
    s3.add_argument("--out", required=True)
    s4 = sub.add_parser("dl3dv-raw", help="raw DL3DV-10K scene dirs")
    s4.add_argument("--root", required=True)
    s4.add_argument("--out", required=True)
    s4.add_argument("--require_caption", action="store_true")
    s5 = sub.add_parser("urbangen-pkl", help="UrbanGen annotation pkl")
    s5.add_argument("--annotation", required=True)
    s5.add_argument("--out", required=True)
    s6 = sub.add_parser("co3d", help="CO3D frame_annotations.jgz categories")
    s6.add_argument("--root", required=True)
    s6.add_argument("--out", required=True)
    s6.add_argument("--categories", nargs="*", default=None)
    s8 = sub.add_parser(
        "co3d-depth", help="CO3D per-frame proxy depth from sequence "
                           "pointclouds (reference tools/co3d/get_proxy.py)")
    s8.add_argument("--root", required=True)
    s8.add_argument("--annotation", required=True,
                    help="pkl produced by the 'co3d' subcommand")
    s8.add_argument("--out", required=True)
    s8.add_argument("--mode", choices=["obb", "points"], default="obb")
    s8.add_argument("--depth_size", type=int, default=256)
    s8.add_argument("--categories", nargs="*", default=None)
    s7 = sub.add_parser("blender", help="Blender/NeRF-synthetic renders "
                                        "(legacy ShapeNet/OmniObject3D)")
    s7.add_argument("--root", required=True)
    s7.add_argument("--out", required=True)
    s7.add_argument("--prompt_suffix", default="")
    s9 = sub.add_parser("t2i-captions",
                        help="SAM-1B/JourneyDB caption sidecars -> T2I "
                             "annotations.json")
    s9.add_argument("--root", required=True)
    s9.add_argument("--out", required=True)
    s9.add_argument("--filelist", default=None)
    s10 = sub.add_parser("mvimgnet",
                         help="MVImgNet category/scene COLMAP models "
                              "(text or binary) -> one annotation pkl")
    s10.add_argument("--root", required=True)
    s10.add_argument("--out", required=True)
    s10.add_argument("--category", default="all")
    s11 = sub.add_parser("journeydb-csv",
                         help="JourneyDB raw caption CSV -> sharded "
                              "filenames_and_captions CSVs for T2I")
    s11.add_argument("--raw_csv", required=True)
    s11.add_argument("--out", required=True)
    s11.add_argument("--shard_size", type=int, default=100000)
    s11.add_argument("--mode", default="full")
    s11.add_argument("--image_root", default=None,
                     help="filter rows to images that exist here")
    args = ap.parse_args(argv)
    if args.cmd == "scan-scenes":
        scan_scenes(args.root, args.out)
    elif args.cmd == "re10k-index":
        re10k_index(args.root)
    elif args.cmd == "colmap":
        colmap_to_annotation(args.root, args.out)
    elif args.cmd == "dl3dv-raw":
        dl3dv_raw(args.root, args.out, args.require_caption)
    elif args.cmd == "urbangen-pkl":
        urbangen_pkl(args.annotation, args.out)
    elif args.cmd == "co3d":
        co3d_annotations(args.root, args.out, args.categories)
    elif args.cmd == "co3d-depth":
        co3d_proxy_depth(args.root, args.annotation, args.out,
                         mode=args.mode, depth_size=args.depth_size,
                         categories=args.categories)
    elif args.cmd == "blender":
        blender_transforms(args.root, args.out, args.prompt_suffix)
    elif args.cmd == "t2i-captions":
        t2i_captions(args.root, args.out, args.filelist)
    elif args.cmd == "mvimgnet":
        mvimgnet_annotations(args.root, args.out, args.category)
    elif args.cmd == "journeydb-csv":
        journeydb_csv(args.raw_csv, args.out, args.shard_size, args.mode,
                      args.image_root)


if __name__ == "__main__":
    main()
