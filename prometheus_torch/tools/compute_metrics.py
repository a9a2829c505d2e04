"""Aggregate no-reference and text-alignment metrics over generated
galleries (the counterpart of the repo's ``tools/compute_metrics.py``)::

    python -m prometheus_torch.tools.compute_metrics --input_dir DIR \\
        [--method {prometheus,director3d,lgm,gaussiandreamer}] \\
        [--brisque_svr allmodel --brisque_range allrange] \\
        [--niqe_mat niqe_image_params.mat] \\
        [--clip_ckpt FILE_OR_BUNDLE [--clip_image_ckpt FILE]] \\
        [--max_prompts N] [--device cpu]

It walks the per-prompt directories of a method's output, scores every
frame with BRISQUE and NIQE (the port's ``metrics.py``) and, with CLIP
towers, the CLIP text-image similarity, and writes
``<input_dir>/all_metric.json`` with per-prompt and averaged results.

Method layouts:
    prometheus (this repo) : <dir>/<prompt>/view_*.png (the eval CLI's) or
                             <dir>/<prompt>/0/<prompt>/*.png
    director3d             : <dir>/<prompt>/0/<prompt>/*.png
    lgm                    : <dir>/<prompt>/<prompt>/*.png
    gaussiandreamer        : <dir>/<prompt>/save/it1200-test/*.png

The official metric assets are used when given (``--brisque_svr`` /
``--brisque_range``: libsvm ``allmodel`` / ``allrange``; ``--niqe_mat``:
``niqe_image_params.mat``); otherwise the NSS proxies run and the output
says so. The CLIP score needs converted towers: ``--clip_ckpt`` is a torch
file with ``clip_image`` and ``clip_text`` state dicts in the port's names
(``checkpoint.load_torch_state_dict``), or the port's release bundle
directory, whose MV-LDM text tower is used beside the image tower of
``--clip_image_ckpt`` (a state dict file; it also replaces a file's
``clip_image``). Each tower is built at the widths its state dict holds
(ViT-H/14 and SD-2.1's text tower for the published weights). Without ``--clip_ckpt`` the CLIP score is skipped: a random
tower's similarity means nothing. Files are unpickled: read only trusted
ones.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..metrics import brisque, niqe

METHODS = ("prometheus", "director3d", "lgm", "gaussiandreamer")


def find_frames(prompt_dir: str, method: str) -> list[str]:
    """The frame images of one prompt's directory in ``method``'s layout."""
    sub = {
        "prometheus": [".", "0"],
        "director3d": ["0"],
        "lgm": ["."],
        "gaussiandreamer": [os.path.join("save", "it1200-test")],
    }[method]
    candidates = [prompt_dir]
    name = os.path.basename(prompt_dir.rstrip("/"))
    for s in sub:
        candidates += [os.path.join(prompt_dir, s),
                       os.path.join(prompt_dir, s, name)]
    for c in candidates:
        if not os.path.isdir(c):
            continue
        frames = sorted(
            os.path.join(c, f) for f in os.listdir(c)
            if f.lower().endswith((".png", ".jpg", ".jpeg"))
            and not f.startswith(("grid", "cam_", "mv_")))
        if frames:
            return frames
    return []


def _num_layers(sd: dict) -> int:
    return len({k.split(".", 1)[0] for k in sd if k.startswith("layer_")})


def clip_text_widths(sd: dict) -> dict:
    """``CLIPTextModel`` kwargs from its state dict; the head count at
    SD-2.1's head width of 64 (1024 / 16)."""
    vocab, width = sd["token_embedding.weight"].shape
    return dict(vocab_size=vocab, width=width, num_heads=width // 64,
                num_layers=_num_layers(sd),
                context_length=sd["position_embedding"].shape[0])


def clip_image_widths(sd: dict) -> dict:
    """``CLIPImageEncoder`` kwargs from its state dict; the head count at
    ViT-H/14's head width of 80 (1280 / 16), the laion towers' erf GELU."""
    width, _, patch, _ = sd["patch_embed.weight"].shape
    grid = round((sd["position_embedding"].shape[0] - 1) ** 0.5)
    return dict(image_size=grid * patch, patch=patch, width=width,
                num_heads=width // 80, num_layers=_num_layers(sd),
                proj_dim=sd["visual_projection.weight"].shape[0])


def load_clip_towers(clip_ckpt: str, clip_image_ckpt: str | None,
                     device: torch.device):
    """``(image tower, text tower)`` in float32 on ``device``, eval mode,
    each built at the widths its state dict holds (``clip_image_widths``,
    ``clip_text_widths``)."""
    from ..checkpoint import bundle_tower, load_torch_state_dict
    from ..models import CLIPImageEncoder, CLIPTextModel

    if os.path.isdir(clip_ckpt):
        if not clip_image_ckpt:
            raise SystemExit("--clip_ckpt names a release bundle, which "
                             "holds no image tower: give --clip_image_ckpt")
        mv = bundle_tower(clip_ckpt, "mvldm")
        text_sd = {k[len("text_encoder."):]: v.float() for k, v in mv.items()
                   if k.startswith("text_encoder.")}
        image_sd = load_torch_state_dict(clip_image_ckpt)
    else:
        text_sd = load_torch_state_dict(clip_ckpt, "clip_text")
        image_sd = (load_torch_state_dict(clip_image_ckpt) if clip_image_ckpt
                    else load_torch_state_dict(clip_ckpt, "clip_image"))
    text = CLIPTextModel(**clip_text_widths(text_sd))
    text.load_state_dict(text_sd)
    image = CLIPImageEncoder(**clip_image_widths(image_sd))
    image.load_state_dict(image_sd)
    return image.to(device).eval(), text.to(device).eval()


def clip_scorer(image_tower, text_tower, tokenizer, device: torch.device):
    """``score(pil_image, prompt)``: the cosine similarity of the image
    tower's embedding of the 224^2 image and the text tower's token-mean
    embedding of the prompt."""

    @torch.no_grad()
    def score(pil_img, prompt: str) -> float:
        img = np.asarray(pil_img.resize((224, 224))) / 127.5 - 1.0
        x = torch.tensor(img.transpose(2, 0, 1)[None], dtype=torch.float32,
                         device=device)
        fi = image_tower(x).float()
        ids = torch.from_numpy(tokenizer([prompt])).to(device)
        ft = text_tower(ids).float().mean(dim=1)       # pooled text feature
        a = fi / fi.norm(dim=-1, keepdim=True)
        b = ft / ft.norm(dim=-1, keepdim=True)
        return float((a * b).sum(-1).mean())

    return score


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="BRISQUE, NIQE and CLIP score over generated galleries")
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--method", default="prometheus", choices=list(METHODS))
    ap.add_argument("--brisque_svr", default=None)
    ap.add_argument("--brisque_range", default=None)
    ap.add_argument("--niqe_mat", default=None)
    ap.add_argument("--clip_ckpt", default=None,
                    help="converted CLIP towers (a torch file with "
                         "clip_image and clip_text) or a release bundle")
    ap.add_argument("--clip_image_ckpt", default=None,
                    help="the image tower's state dict, beside a bundle")
    ap.add_argument("--bpe_vocab", default=None,
                    help="the CLIP tokenizer's merges file")
    ap.add_argument("--max_prompts", type=int, default=-1)
    ap.add_argument("--device", default="cuda",
                    help="where the CLIP towers run: 'cuda' or 'cpu'")
    args = ap.parse_args(argv)

    from PIL import Image

    official = args.brisque_svr is not None or args.niqe_mat is not None
    clip_encode = None
    if args.clip_ckpt:
        from ..models import CLIPTokenizer
        from ..utils import resolve_device

        device = resolve_device(args.device)
        clip_encode = clip_scorer(
            *load_clip_towers(args.clip_ckpt, args.clip_image_ckpt, device),
            CLIPTokenizer(args.bpe_vocab), device)

    prompt_dirs = sorted(
        os.path.join(args.input_dir, d) for d in os.listdir(args.input_dir)
        if os.path.isdir(os.path.join(args.input_dir, d)))
    if args.max_prompts > 0:
        prompt_dirs = prompt_dirs[: args.max_prompts]

    per_prompt, nq_all, bq_all, cs_all = [], [], [], []
    for pdir in prompt_dirs:
        frames = find_frames(pdir, args.method)
        if not frames:
            continue
        prompt = os.path.basename(pdir).replace("_", " ")
        nq, bq, cs = [], [], []
        for fpath in frames:
            try:
                pil = Image.open(fpath).convert("RGB")
            except OSError:
                continue
            arr = np.asarray(pil, np.float32) / 255.0
            nq.append(niqe(arr, model_params=args.niqe_mat))
            bq.append(brisque(arr, svr_params=args.brisque_svr,
                              feature_range=args.brisque_range))
            if clip_encode is not None:
                cs.append(clip_encode(pil, prompt))
        entry = {"prompt": prompt, "n_frames": len(nq),
                 "niqe": float(np.mean(nq)), "brisque": float(np.mean(bq))}
        if cs:
            entry["clip_score"] = float(np.mean(cs))
            cs_all.append(entry["clip_score"])
        nq_all.append(entry["niqe"])
        bq_all.append(entry["brisque"])
        per_prompt.append(entry)
        print(f"[{len(per_prompt)}/{len(prompt_dirs)}] {prompt[:50]}: "
              f"niqe={entry['niqe']:.3f} brisque={entry['brisque']:.3f}")

    out = {
        "method": args.method,
        "metrics_are_proxies": not official,
        "average_niqe": float(np.mean(nq_all)) if nq_all else None,
        "average_BRISQUE": float(np.mean(bq_all)) if bq_all else None,
        "average_CLIP_score": float(np.mean(cs_all)) if cs_all else None,
        "per_prompt": per_prompt,
    }
    with open(os.path.join(args.input_dir, "all_metric.json"), "w") as fp:
        json.dump(out, fp, indent=2)
    print(json.dumps({k: v for k, v in out.items() if k != "per_prompt"}))
    return out


if __name__ == "__main__":
    main()
