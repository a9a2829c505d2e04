"""Command-line tools of the port (``python -m
prometheus_torch.tools.<name>``): ``create_final_ckpt`` bundles trained
stage checkpoints into a release bundle, ``convert_ckpt`` converts a
published ``full.ckpt`` into one."""
