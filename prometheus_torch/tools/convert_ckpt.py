"""Convert the published torch ``full.ckpt`` bundle into the port's release
bundle (the counterpart of the repo's ``tools/convert_ckpt.py``).

``checkpoint.split_full_ckpt`` splits the file into its towers,
``checkpoint.convert_bundle`` writes them through ``weight_maps.py``'s
tables into a pipeline at flagship (or ``--small``) widths, and
``checkpoint.save_bundle`` writes ``OUT/bundle.pt`` beside
``OUT/conversion_report.json``. Every source tensor is mapped or listed as
missing, unassigned, unmapped or skipped; the per-tower counts are
printed::

    python -m prometheus_torch.tools.convert_ckpt --full_ckpt \\
        pretrained/full.ckpt --out pretrained/bundle [--small] \\
        [--device cpu]

The file is unpickled: convert only trusted files. The bundle holds the
pipeline's dtype (bf16 on the card, float32 with ``--device cpu``).
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from ..checkpoint import convert_bundle, save_bundle, split_full_ckpt
from ..pipeline import build_pipeline
from ..utils import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Convert a published full.ckpt into the port's bundle")
    ap.add_argument("--full_ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--small", action="store_true",
                    help="the reduced test widths")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    towers = split_full_ckpt(args.full_ckpt)
    pipe = build_pipeline(small=args.small, device=device, dtype=dtype)
    report = convert_bundle(towers, pipe)
    save_bundle(args.out, pipe)
    with open(os.path.join(args.out, "conversion_report.json"), "w") as fp:
        json.dump(report, fp, indent=2)
    print(json.dumps({k: {kk: (len(vv) if isinstance(vv, list) else vv)
                          for kk, vv in v.items()}
                      for k, v in report.items()}, indent=2))
    return report


if __name__ == "__main__":
    main()
