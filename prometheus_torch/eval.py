"""Benchmark evaluation CLI of the port (the repo's ``eval.py``): text to
3D over a prompt set with its camera trajectories, frame galleries and
no-reference quality proxies::

    python -m prometheus_torch.eval \\
        --benchmark_dir benchmarks/scene_benchmark80
    python -m prometheus_torch.eval \\
        --benchmark_dir benchmarks/scene_benchmark80 --small --device cpu \\
        --num_steps 2 --num_views 2 --render_size 64 --image_size 64 \\
        --max_prompts 1

Each prompt of the benchmark (``load_benchmark``) goes through
``PrometheusPipeline.generate``: with its trajectory cut to ``--num_views``
sparse views (``sparse_views``), or through TrajDiT where it has none;
optionally refined (``--refine``) or in 3D mode. Its renders are written
to ``<export_dir>/<i:04d>/view_NN.png`` and ``grid.png``. A prompt whose
views are all there already is skipped and its frames reloaded (an
interrupted sweep resumes; ``--no_skip_existing`` regenerates). The BRISQUE
and NIQE proxies (``metrics.py``: NSS proxies, not the calibrated scores)
of each prompt's views, averaged, and their means over the prompts go to
``<export_dir>/metrics.json``.

``--ckpt`` loads trained weights as the port's inference CLI does (a
release bundle directory or a ``full.ckpt``; random weights, seed 0,
without it).
Prompt ``i`` draws its noise from the generator of ``inference.
sample_generator(seed + i, 0)``. ``run(args, pipe)`` drives the CLI with a
pipeline that is already built.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np
import torch

from .inference import pipeline_from_args, sample_generator
from .metrics import brisque, niqe
from .utils.image import load_image, make_grid, postprocess_image, save_image


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Benchmark evaluation on the PyTorch/CUDA port")
    p.add_argument("--benchmark_dir", type=str, required=True,
                   help="dir with index.json + camera/<i>.npy, or "
                        "prompts.txt and optional camera/<i:04d>.pkl|npy")
    p.add_argument("--export_dir", type=str, default="./eval_out")
    p.add_argument("--num_steps", type=int, default=100)
    p.add_argument("--num_views", type=int, default=8)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--guidance_type", type=str, default="joint")
    p.add_argument("--cfg_rescale", type=float, default=0.7)
    p.add_argument("--render_size", type=int, default=512)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--small", action="store_true",
                   help="the reduced test widths")
    p.add_argument("--ckpt", type=str, default=None,
                   help="a release bundle directory or a full.ckpt file; "
                        "random weights if absent")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_prompts", type=int, default=-1)
    p.add_argument("--traj_idx", type=int, default=0,
                   help="candidate index for (C, N, 18) trajectory files")
    p.add_argument("--compute_metrics", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="per-prompt proxy metrics (--no-compute_metrics "
                        "disables)")
    p.add_argument("--refine", type=str, default=None,
                   choices=["sds", "mv_sds"],
                   help="SDS++ refinement before export")
    p.add_argument("--refine_iters", type=int, default=300)
    p.add_argument("--use_3d_mode_every_m_steps", type=int, default=-1)
    p.add_argument("--no_skip_existing", action="store_true",
                   help="regenerate prompts whose views are already "
                        "exported (default: skip them)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def load_benchmark(bench_dir: str, traj_idx: int = 0) -> list:
    """``[(prompt, cameras (1, N, 18) float32 or None)]``.

    ``index.json`` with ``camera/<i>.npy`` (``tools/import_benchmarks.py``'s
    layout of scene_benchmark80, gpt4v_gallery and t3bench); a ``(C, N,
    18)`` file holds candidates, of which ``traj_idx`` (clamped) is taken.
    Otherwise ``prompts.txt`` with an optional ``camera/<i:04d>.pkl`` or
    ``.npy`` per prompt (the pickles are unpickled: trusted benchmark
    directories only)."""
    index_path = os.path.join(bench_dir, "index.json")
    entries = []
    if os.path.exists(index_path):
        with open(index_path) as fp:
            index = json.load(fp)
        for e in index:
            cams = np.load(os.path.join(bench_dir, e["camera"])).astype(
                np.float32)
            if cams.ndim == 3:
                cams = cams[min(traj_idx, cams.shape[0] - 1)]
            entries.append((e["text"], cams[None]))
        return entries
    with open(os.path.join(bench_dir, "prompts.txt")) as fp:
        prompts = [line.strip() for line in fp if line.strip()]
    cam_dir = os.path.join(bench_dir, "camera")
    for i, prompt in enumerate(prompts):
        cams = None
        for ext in (".pkl", ".npy"):
            path = os.path.join(cam_dir, f"{i:04d}{ext}")
            if os.path.exists(path):
                if ext == ".pkl":
                    with open(path, "rb") as fp:
                        cams = pickle.load(fp)
                else:
                    cams = np.load(path)
                cams = np.asarray(cams, np.float32)
                if cams.ndim == 2:
                    cams = cams[None]
                break
        entries.append((prompt, cams))
    return entries


def run(args, pipe=None) -> dict:
    """Sweep the benchmark; returns ``{"summary": metrics.json's dict,
    "records": [per prompt: dir, skipped, seconds, stage timings]}``.
    ``pipe``: a pipeline already built (used as it is), else one is
    built from ``args``."""
    if pipe is None:
        pipe = pipeline_from_args(args)
    entries = load_benchmark(args.benchmark_dir, traj_idx=args.traj_idx)
    if args.max_prompts > 0:
        entries = entries[:args.max_prompts]
    refiner = None
    if args.refine:
        refiner = pipe.build_refiner(args.refine,
                                     total_iterations=args.refine_iters,
                                     img_size=min(args.render_size, 256))
    per_prompt, records = [], []
    for i, (prompt, cams) in enumerate(entries):
        out_dir = os.path.join(args.export_dir, f"{i:04d}")
        view_paths = [os.path.join(out_dir, f"view_{v:02d}.png")
                      for v in range(args.num_views)]
        t0 = time.perf_counter()
        skipped = (not args.no_skip_existing
                   and all(os.path.exists(p) for p in view_paths))
        timings = {}
        if skipped:
            frames = np.stack([load_image(p) for p in view_paths])
            note = " (existing, skipped)"
        else:
            kw = dict(num_views=args.num_views,
                      num_inference_steps=args.num_steps,
                      guidance_scale=args.guidance_scale,
                      guidance_type=args.guidance_type,
                      cfg_rescale=args.cfg_rescale,
                      render_size=args.render_size,
                      image_size=args.image_size, refiner=refiner,
                      use_3d_mode_every_m_steps=args.use_3d_mode_every_m_steps)
            if cams is not None:
                kw["cameras"] = pipe.sparse_views(
                    torch.from_numpy(cams).to(pipe.device), args.num_views)
            result = pipe.generate(
                prompt, generator=sample_generator(args.seed + i, 0,
                                                   pipe.device), **kw)
            timings = result["timings"]
            frames = postprocess_image(
                result["images_gs_render"][0].float().cpu().numpy())
            os.makedirs(out_dir, exist_ok=True)
            for path, frame in zip(view_paths, frames):
                save_image(frame, path)
            save_image(make_grid(frames), os.path.join(out_dir, "grid.png"))
            note = ""
        entry = {"prompt": prompt, "dir": out_dir}
        if args.compute_metrics:
            imgs = frames.astype(np.float32) / 255.0
            entry["brisque_proxy"] = float(np.mean([brisque(f)
                                                    for f in imgs]))
            entry["niqe_proxy"] = float(np.mean([niqe(f) for f in imgs]))
        seconds = time.perf_counter() - t0
        per_prompt.append(entry)
        records.append(dict(dir=out_dir, skipped=skipped, seconds=seconds,
                            timings=timings))
        print(f"[{i + 1}/{len(entries)}] {prompt[:60]} -> {out_dir}{note} "
              f"({seconds:.1f}s)")
    summary = {"num_prompts": len(per_prompt),
               "metrics_are_proxies": bool(args.compute_metrics),
               "per_prompt": per_prompt}
    if args.compute_metrics:
        for key in ("brisque_proxy", "niqe_proxy"):
            summary[f"{key}_mean"] = float(np.mean([m[key]
                                                    for m in per_prompt]))
    os.makedirs(args.export_dir, exist_ok=True)
    with open(os.path.join(args.export_dir, "metrics.json"), "w") as fp:
        json.dump(summary, fp, indent=2)
    print(json.dumps({k: v for k, v in summary.items() if k != "per_prompt"}))
    return {"summary": summary, "records": records}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
