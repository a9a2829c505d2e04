"""Write scene captions with a vision-language model (the counterpart of
the repo's ``tools/generate_captions.py``, same arguments and files).

Model-agnostic: point ``--model_path`` at any HF-format VLM (its weights
must be on the disk: ``transformers`` loads with ``local_files_only``; it
is imported only on that path), or pass ``--heuristic`` for placeholder
captions named after the dataset and the scene, for smoke runs.

Output: one ``<scene>.txt`` a scene under ``--out``, one caption a line,
the layout ``datasets.MultiviewDataset.get_caption`` reads.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True, help="annotated-scenes root")
    ap.add_argument("--annotation", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--model_path", default=None,
                    help="local HF VLM dir (e.g. InternVL/InternLM-XC)")
    ap.add_argument("--heuristic", action="store_true",
                    help="placeholder captions (no model)")
    ap.add_argument("--frames_per_scene", type=int, default=1)
    args = ap.parse_args(argv)

    from ..datasets.base import load_annotation

    ann = load_annotation(args.annotation) if args.annotation else None
    if ann is None:
        raise SystemExit("provide --annotation (see "
                         "prometheus_torch.tools.build_metadata)")
    os.makedirs(args.out, exist_ok=True)

    captioner = None
    if args.model_path:
        from transformers import AutoModelForCausalLM, AutoProcessor

        processor = AutoProcessor.from_pretrained(args.model_path,
                                                  local_files_only=True)
        model = AutoModelForCausalLM.from_pretrained(args.model_path,
                                                     local_files_only=True)

        def captioner(image):
            inputs = processor(images=image,
                               text="Describe this scene in one sentence.",
                               return_tensors="pt")
            out = model.generate(**inputs, max_new_tokens=48)
            return processor.decode(out[0], skip_special_tokens=True)
    elif not args.heuristic:
        raise SystemExit("provide --model_path or --heuristic")

    from PIL import Image

    for scene, meta in ann.items():
        lines = []
        if captioner is not None:
            step = max(len(meta["frames"]) // args.frames_per_scene, 1)
            for f in meta["frames"][::step][: args.frames_per_scene]:
                img = Image.open(os.path.join(args.root, f)).convert("RGB")
                lines.append(captioner(img).strip())
        else:
            lines.append(f"a scene from {os.path.basename(args.root)}: {scene}")
        with open(os.path.join(args.out, f"{scene}.txt"), "w") as fp:
            fp.write("\n".join(lines))
    print(f"[captions] wrote {len(ann)} scene caption files to {args.out}")


if __name__ == "__main__":
    main()
