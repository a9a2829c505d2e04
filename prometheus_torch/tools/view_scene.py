"""Export an interactive HTML viewer for a generated 3DGS scene (the
counterpart of the repo's ``tools/view_scene.py``): one standalone HTML
file (a WebGL2 splat renderer, the scene embedded) to open in a browser,
serve or share; no Python process and no network at view time::

    python -m prometheus_torch.tools.view_scene scene.splat [--out v.html]
    python -m prometheus_torch.tools.view_scene scene.ply [--max_splats N]
    python -m prometheus_torch.tools.view_scene scene.splat --fetch

The inference and eval CLIs write ``gaussians.splat`` beside the ``.ply``;
point this tool at either. A ``.ply`` is read by ``utils/gs_io.py::
load_ply`` and quantized in memory; ``--fetch`` references the ``.splat``
by its relative URL instead of embedding it (a smaller HTML that needs an
HTTP server).
"""
from __future__ import annotations

import argparse
import os

from ..utils.gs_io import load_ply
from ..utils.viewer_html import export_viewer_html, gaussians_to_splat_bytes


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(
        description="Export a standalone HTML viewer for a 3DGS scene")
    ap.add_argument("scene", help=".splat or .ply file")
    ap.add_argument("--out", default=None,
                    help="output html (default: <scene>.viewer.html)")
    ap.add_argument("--max_splats", type=int, default=500_000,
                    help="embed at most this many (importance-ordered) "
                         "splats")
    ap.add_argument("--title", default=None)
    ap.add_argument("--fetch", action="store_true",
                    help="reference the .splat by relative URL instead of "
                         "embedding it (smaller html; needs an http server)")
    args = ap.parse_args(argv)

    scene = args.scene
    out = args.out or os.path.splitext(scene)[0] + ".viewer.html"
    title = args.title or os.path.basename(scene)
    if scene.endswith(".ply"):
        path = export_viewer_html(
            out, gaussians_to_splat_bytes(load_ply(scene)), title=title,
            max_splats=args.max_splats)
    elif args.fetch:
        rel = os.path.relpath(scene, os.path.dirname(out) or ".")
        path = export_viewer_html(out, None, title=title, fetch_url=rel)
    else:
        path = export_viewer_html(out, scene, title=title,
                                  max_splats=args.max_splats)
    print(f"wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB)")
    return path


if __name__ == "__main__":
    main()
