"""3D Gaussian import/export: ``.ply`` (INRIA format) and ``.splat``
(antimatter15), numpy only (``prometheus_tpu/utils/gs_io.py``, same bytes):

- ``.ply``: binary_little_endian vertex element with fields
  ``x y z f_dc_{0..2} opacity scale_{0..2} rot_{0..3}`` (all float32). With
  ``compatible=True`` opacity is stored as logit(opacity) and scales as
  log(scales), matching the original 3DGS checkpoint convention. Note the
  reference stores *raw [0,1] colors* in ``f_dc_*`` (not SH coefficients); we
  keep that behavior for parity.
- ``.splat``: per-gaussian 32-byte records ``[xyz f32x3][scales f32x3]
  [rgba u8x4][quat u8x4]``, sorted by descending volume x opacity.

Gaussians tuple layout: ``(xyz (B,N,3), features (B,N,1,3), opacity (B,N,1),
scales (B,N,3), rotations (B,N,4))``, activations applied, as numpy arrays
or CPU tensors.
"""
from __future__ import annotations

import numpy as np

SH_C0 = 0.28209479177387814

_PLY_FIELDS = (
    ["x", "y", "z"]
    + [f"f_dc_{i}" for i in range(3)]
    + ["opacity"]
    + [f"scale_{i}" for i in range(3)]
    + [f"rot_{i}" for i in range(4)]
)


def _inverse_sigmoid(x, eps=1e-8):
    x = np.clip(x, eps, 1 - eps)
    return np.log(x / (1 - x))


def _unbatch(gaussians):
    """Accept (B,N,...) or (N,...) gaussian tuples; return numpy (N,...) arrays."""
    arrs = [np.asarray(g, dtype=np.float32) for g in gaussians]
    xyz = arrs[0]
    if xyz.ndim == 3:  # batched: take scene 0, matching the reference exporter
        arrs = [a[0] for a in arrs]
    return arrs


def export_ply(path: str, gaussians, opacity_threshold: float = 0.0,
               compatible: bool = True) -> int:
    """Write a binary ``.ply``; returns the number of points kept after pruning."""
    xyz, features, opacity, scales, rotations = _unbatch(gaussians)
    colors = features.reshape(features.shape[0], -1)[:, :3]

    mask = opacity[..., 0] >= opacity_threshold
    xyz, colors, opacity, scales, rotations = (
        a[mask] for a in (xyz, colors, opacity, scales, rotations)
    )
    if compatible:
        opacity = _inverse_sigmoid(opacity)
        scales = np.log(scales + 1e-8)

    n = xyz.shape[0]
    data = np.concatenate([xyz, colors, opacity, scales, rotations], axis=1).astype("<f4")
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {f}\n" for f in _PLY_FIELDS)
        + "end_header\n"
    )
    if not path.endswith(".ply"):
        path = path + ".ply"
    with open(path, "wb") as fp:
        fp.write(header.encode("ascii"))
        fp.write(data.tobytes())
    return n


def load_ply(path: str, compatible: bool = True):
    """Read a ``.ply`` written by :func:`export_ply` (or the original 3DGS format).

    Returns the batched gaussian tuple ``(xyz (1,N,3), features (1,N,1,3),
    opacity (1,N,1), scales (1,N,3), rotations (1,N,4))`` as numpy arrays.
    """
    with open(path, "rb") as fp:
        blob = fp.read()
    end = blob.index(b"end_header\n") + len(b"end_header\n")
    header = blob[:end].decode("ascii").splitlines()
    fields, n = [], 0
    for line in header:
        if line.startswith("element vertex"):
            n = int(line.split()[-1])
        elif line.startswith("property float"):
            fields.append(line.split()[-1])
    rec = np.frombuffer(blob[end:], dtype="<f4").reshape(n, len(fields))
    col = {f: rec[:, i] for i, f in enumerate(fields)}

    xyz = np.stack([col["x"], col["y"], col["z"]], -1)
    feats = np.stack([col[f"f_dc_{i}"] for i in range(3)], -1)[:, None, :]
    opacity = col["opacity"][:, None]
    scale_names = sorted(f for f in fields if f.startswith("scale_"))
    scales = np.stack([col[f] for f in scale_names], -1)
    rot_names = sorted(f for f in fields if f.startswith("rot_"))
    rotations = np.stack([col[f] for f in rot_names], -1)
    if compatible:
        opacity = 1.0 / (1.0 + np.exp(-opacity))
        scales = np.exp(scales)
    return (xyz[None], feats[None], opacity[None], scales[None], rotations[None])


def export_splat(path: str, gaussians, opacity_threshold: float = 0.0) -> int:
    """Write an antimatter15-style ``.splat`` (sorted, quantized) file."""
    xyz, features, opacity, scales, rotations = _unbatch(gaussians)
    colors = features.reshape(features.shape[0], -1)[:, :3]

    mask = opacity[..., 0] >= opacity_threshold
    xyz, colors, opacity, scales, rotations = (
        a[mask] for a in (xyz, colors, opacity, scales, rotations)
    )
    order = np.argsort(-(scales.prod(-1) * opacity[:, 0]))
    xyz, colors, opacity, scales, rotations = (
        a[order] for a in (xyz, colors, opacity, scales, rotations)
    )
    # Reference quirk kept for parity: rgba = 0.5 + SH_C0 * color (treats the
    # stored [0,1] colors as SH DC terms).
    rgba = np.concatenate([0.5 + SH_C0 * colors, opacity], axis=1)
    rgba_u8 = np.clip(rgba * 255, 0, 255).astype(np.uint8)
    quat = rotations / np.maximum(np.linalg.norm(rotations, axis=-1, keepdims=True), 1e-8)
    quat_u8 = np.clip(quat * 128 + 128, 0, 255).astype(np.uint8)

    n = xyz.shape[0]
    rec = np.empty(n, dtype=[("pos", "<f4", 3), ("scale", "<f4", 3),
                             ("rgba", "u1", 4), ("quat", "u1", 4)])
    rec["pos"], rec["scale"], rec["rgba"], rec["quat"] = xyz, scales, rgba_u8, quat_u8
    if not path.endswith(".splat"):
        path = path + ".splat"
    with open(path, "wb") as fp:
        fp.write(rec.tobytes())
    return n


def export_gaussians(path_base: str, gaussians, opacity_threshold: float = 0.0):
    """Write both ``<base>.ply`` and ``<base>.splat`` (reference export parity)."""
    export_ply(path_base + ".ply", gaussians, opacity_threshold)
    export_splat(path_base + ".splat", gaussians, opacity_threshold)
