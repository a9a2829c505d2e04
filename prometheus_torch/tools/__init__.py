"""Command-line tools of the port (``python -m
prometheus_torch.tools.<name>``): ``create_final_ckpt`` bundles trained
stage checkpoints into a release bundle, ``convert_ckpt`` converts a
published ``full.ckpt`` into one, ``view_scene`` writes a standalone HTML
viewer of a ``.ply`` or ``.splat`` scene, and ``compute_metrics`` scores
generated galleries (BRISQUE, NIQE, CLIP)."""
