"""Text -> 3DGS scene CLI of the port (the JAX package's ``inference.py``).

Runs TrajDiT -> sparse views -> MV-LDM sampling (any guidance type, Euler
or DPM-Solver++(2M), optionally guided on a high-noise interval only, or in
3D mode) -> VAE decode -> GS decoder -> renders -> optional SDS++ refinement
(``--refine mv_sds|sds``) on one card (or on the CPU with ``--device cpu``)
and writes, per prompt and sample, the JAX CLI's files: ``gs_renders.png``,
``gs_renders_refined.png`` (with ``--refine``), ``mv_images.png``,
``mv_depths.png``, ``gaussians.ply``, ``gaussians.splat``, ``orbit.mp4``
(``orbit.gif`` where no mp4 writer is installed) and ``meta.json``.
``--ref_image PNG`` (image to 3D) first writes the same files for the
scene generated from that image under ``<export_dir>/image_to_3d/``: the
image is centre-cropped, resized to the MV-LDM's image size and embedded by
the CLIP image tower, its disparity comes from the DA2-Small teacher, and
the scene has ``--num_views`` random orbit cameras.

    python -m prometheus_torch.inference --prompt "a cozy cabin"
    python -m prometheus_torch.inference --prompt "a cozy cabin" \\
        --ckpt pretrained/bundle
    python -m prometheus_torch.inference --prompt "x" --small --device cpu \\
        --num_steps 2 --num_traj_steps 4 --render_size 32 \\
        --num_video_frames 4 --refine mv_sds --refine_iters 2
    python -m prometheus_torch.inference --ref_image ref.png --small \\
        --device cpu --num_steps 2 --render_size 32 --num_video_frames 4

``--ckpt`` loads trained weights (``pipeline.load_checkpoint``): a
directory is the port's release bundle (``python -m prometheus_torch.tools.
create_final_ckpt``), a file the reference's published ``full.ckpt``;
without it, or where the path does not exist, the weights are random
(``pipeline.build_pipeline``, seed 0), as in the JAX CLI. ``--ref_image``'s
image tower and depth teacher stay random (``pipeline.
attach_image_to_3d``).

``--shard_views`` under ``torchrun`` (``torchrun --nproc_per_node=N -m
prometheus_torch.inference --shard_views ...``; ``nccl``, each rank on
``cuda:$LOCAL_RANK``, or ``gloo`` with ``--device cpu``) splits each
scene's views over the ranks: the sampler and the decode and render run
view-sharded (``generate(view_shard_group=...)``) and the orbit video's
frames are split too; rank 0 writes the files. ``--num_views`` must be a
multiple of the world size. A process alone runs the unsharded path.

Seeds: sample ``j`` of prompt ``i`` draws its trajectory, sampler and
refiner noise from a ``torch.Generator`` seeded from ``(seed + i, j)``, the
image-to-3D scene its cameras and noise from the one seeded from ``(seed,
0)``. The JAX CLI draws from ``PRNGKey(seed + i)`` folded with ``j``, so the
two CLIs draw different noise from the same ``--seed``.

``run(args, pipe)`` drives the CLI with a pipeline that is already built.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

import torch.distributed as dist

from .checkpoint import bundle_widths
from .datasets.transforms import (center_crop_and_resize, decode_image,
                                  normalize_image)
from .models import CLIPTokenizer
from .parallel.dist import init_from_env, is_main_process
from .pipeline import (attach_image_to_3d, build_pipeline,
                       load_checkpoint)
from .utils import get_random_cameras, resolve_device
from .utils.gs_io import export_gaussians
from .utils.image import (colorize_depth, make_grid, postprocess_image,
                          save_image, save_video)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Text -> 3DGS scene on the PyTorch/CUDA port")
    p.add_argument("--prompt", type=str, default=None)
    p.add_argument("--prompt_file", type=str, default=None)
    p.add_argument("--ref_image", type=str, default=None,
                   help="image to 3D: the reference image (CLIP image "
                        "conditioning), exported to <export_dir>/image_to_3d")
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--use_3d_mode_every_m_steps", type=int, default=-1,
                   help="render-consistent resampling every m steps (-1 off)")
    p.add_argument("--refine", type=str, default=None,
                   choices=["sds", "mv_sds"],
                   help="test-time SDS++ refinement of the gaussians")
    p.add_argument("--refine_iters", type=int, default=300)
    p.add_argument("--ckpt", type=str, default=None,
                   help="a release bundle directory or a full.ckpt file; "
                        "random weights if absent")
    p.add_argument("--export_dir", type=str, default="./exports")
    p.add_argument("--num_steps", type=int, default=100)
    p.add_argument("--num_traj_steps", type=int, default=100)
    p.add_argument("--num_views", type=int, default=8)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--guidance_type", type=str, default="joint",
                   choices=["none", "text", "pose", "joint", "hybrid"])
    p.add_argument("--cfg_rescale", type=float, default=0.7)
    p.add_argument("--sampler", type=str, default="euler",
                   choices=["euler", "dpmpp_2m"],
                   help="euler (the reference's) or DPM-Solver++(2M)")
    p.add_argument("--cfg_interval_frac", type=float, default=None,
                   help="guide only this high-noise fraction of the steps "
                        "(default: every step)")
    p.add_argument("--render_size", type=int, default=512)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--num_samples", type=int, default=1,
                   help="independent samples per prompt")
    p.add_argument("--num_video_frames", type=int, default=120)
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--no_video", action="store_true")
    p.add_argument("--small", action="store_true",
                   help="the reduced test widths")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bpe_vocab", type=str, default=None,
                   help="CLIP BPE merges file (exact tokenization)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--shard_views", action="store_true",
                   help="under torchrun: split each scene's views (and the "
                        "video's frames) over the ranks")
    return p.parse_args(argv)


def sample_generator(seed: int, j: int,
                     device: torch.device) -> torch.Generator:
    """The generator of sample ``j`` of the prompt whose seed is ``seed``."""
    state = np.random.SeedSequence([seed, j]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def export_result(result: dict, pipe, prompt: str, out_dir: str,
                  args, frames: torch.Tensor | None = None
                  ) -> tuple[dict, dict]:
    """Write one scene's files; returns ``(paths, seconds per step)``.
    ``frames``: the orbit video, already rendered (else rendered here)."""
    os.makedirs(out_dir, exist_ok=True)
    paths, seconds = {}, {}
    t0 = time.perf_counter()
    paths["renders"] = os.path.join(out_dir, "gs_renders.png")
    save_image(make_grid(postprocess_image(
        result["images_gs_render"][0].float().cpu().numpy())),
        paths["renders"])
    if "images_sds_gs_render" in result:
        paths["renders_refined"] = os.path.join(out_dir,
                                                "gs_renders_refined.png")
        save_image(make_grid(postprocess_image(
            result["images_sds_gs_render"][0].float().cpu().numpy())),
            paths["renders_refined"])
    paths["images_2d"] = os.path.join(out_dir, "mv_images.png")
    save_image(make_grid(postprocess_image(
        result["images_pred"][0].float().cpu().numpy())), paths["images_2d"])
    paths["depths"] = os.path.join(out_dir, "mv_depths.png")
    deps = result["depths_pred"][0, :, 0].float().cpu().numpy()
    save_image(make_grid(colorize_depth(deps, 0.0, 1.0)), paths["depths"])
    seconds["images"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    gaussians = tuple(g.float().cpu().numpy() for g in result["gaussians"])
    export_gaussians(os.path.join(out_dir, "gaussians"), gaussians)
    paths["ply"] = os.path.join(out_dir, "gaussians.ply")
    paths["splat"] = os.path.join(out_dir, "gaussians.splat")
    seconds["gaussians"] = time.perf_counter() - t0

    if not args.no_video:
        t0 = time.perf_counter()
        if frames is None:
            frames = pipe.render_orbit_video(
                result["gaussians"], result["dense_cameras"],
                num_frames=args.num_video_frames, size=args.render_size)
        seconds["video_render"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        paths["video"] = save_video(postprocess_image(frames.numpy()),
                                    os.path.join(out_dir, "orbit.mp4"),
                                    fps=args.fps)
        seconds["video_write"] = time.perf_counter() - t0

    with open(os.path.join(out_dir, "meta.json"), "w") as fp:
        json.dump({"prompt": prompt, "paths": paths}, fp, indent=2)
    return paths, seconds


def prompts_of(args) -> list[str]:
    prompts = [args.prompt] if args.prompt else []
    if args.prompt_file:
        with open(args.prompt_file) as fp:
            prompts.extend(line.strip() for line in fp if line.strip())
    if not prompts and not args.ref_image:
        raise SystemExit("provide --prompt, --prompt_file, or --ref_image")
    return prompts


def load_reference(path: str, size: int) -> torch.Tensor:
    """The image at ``path``, centre-cropped and resized to ``size``^2, as a
    ``(1, 1, 3, size, size)`` float32 tensor in [-1, 1]."""
    with open(path, "rb") as fp:
        raw = decode_image(fp.read())
    img, _ = center_crop_and_resize(raw, size)
    return torch.from_numpy(normalize_image(img))[None, None]


def run_image_to_3d(args, pipe) -> dict:
    """Generate and export the scene of ``--ref_image`` (a random image
    tower and depth teacher are attached when ``pipe`` has none); returns
    its record as ``run`` does."""
    if pipe.image_encoder is None:
        attach_image_to_3d(pipe, small=args.small, seed=args.seed)
    ref = load_reference(args.ref_image, pipe.mvldm.model.image_size)
    g = sample_generator(args.seed, 0, pipe.device)
    cams = get_random_cameras(args.num_views, g, size=args.image_size,
                              device=pipe.device)[None]
    t0 = time.perf_counter()
    result = pipe.generate_image_to_3d(
        ref, cams, generator=g, num_inference_steps=args.num_steps,
        guidance_scale=args.guidance_scale, cfg_rescale=args.cfg_rescale,
        render_size=args.render_size)
    dt = time.perf_counter() - t0
    out_dir = os.path.join(args.export_dir, "image_to_3d")
    paths, seconds = export_result(result, pipe, f"image:{args.ref_image}",
                                   out_dir, args)
    stages = " ".join(f"{k} {v:.3f}" for k, v in result["timings"].items())
    print(f"[image-to-3d] {args.ref_image} -> {out_dir} ({dt:.1f}s; seconds "
          f"by stage: {stages})")
    return dict(out_dir=out_dir, paths=paths, timings=result["timings"],
                export_seconds=seconds, generate_seconds=dt,
                n_gaussians=int(result["gaussians"][0].shape[1]),
                result=result)


def pipeline_from_args(args, device: torch.device | None = None):
    """The pipeline of ``--small`` / ``--device`` (bf16 on the card, float32
    on the CPU; ``device`` in its place, a rank's own card) with
    ``--ckpt``'s weights loaded, or random ones (the JAX CLI's
    ``build_pipeline``). A bundle directory's towers are built at the
    widths the bundle records, whatever ``--small`` says."""
    device = resolve_device(device or args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    widths = (bundle_widths(args.ckpt) if args.ckpt
              and os.path.isdir(args.ckpt) else None)
    pipe = build_pipeline(small=args.small, device=device, dtype=dtype,
                          widths=widths)
    load_checkpoint(pipe, args.ckpt)
    return pipe


def run(args, pipe=None) -> list[dict]:
    """Generate and export the ``--ref_image`` scene, then every prompt's
    samples. ``pipe``: a pipeline already built (its device and weights
    are used as they are), else one is built from ``args``. Returns one
    record per scene: its directory, files, ``generate``'s stage seconds,
    the export seconds and the wall seconds of ``generate`` (the
    image-to-3D record, first, also holds its ``result``). With
    ``--shard_views`` over a process group (``torchrun``) every rank runs
    it and rank 0 alone writes the files."""
    prompts = prompts_of(args)
    group, device = view_shard_group(args)
    main = is_main_process()
    if pipe is None:
        pipe = pipeline_from_args(args, device)
    if args.bpe_vocab:
        pipe.tokenizer = CLIPTokenizer(args.bpe_vocab)
    records = ([run_image_to_3d(args, pipe)] if args.ref_image and main
               else [])
    refiner = None
    if args.refine and prompts:
        refiner = pipe.build_refiner(args.refine,
                                     total_iterations=args.refine_iters,
                                     img_size=min(args.render_size, 256))
    for i, prompt in enumerate(prompts):
        for j in range(max(1, args.num_samples)):
            t0 = time.perf_counter()
            result = pipe.generate(
                prompt, generator=sample_generator(args.seed + i, j,
                                                   pipe.device),
                num_views=args.num_views,
                num_inference_steps=args.num_steps,
                num_traj_steps=args.num_traj_steps,
                guidance_scale=args.guidance_scale,
                guidance_type=args.guidance_type,
                cfg_rescale=args.cfg_rescale,
                render_size=args.render_size, image_size=args.image_size,
                negative_text=args.negative_prompt, sampler=args.sampler,
                cfg_interval_frac=args.cfg_interval_frac,
                use_3d_mode_every_m_steps=args.use_3d_mode_every_m_steps,
                refiner=refiner, view_shard_group=group)
            dt = time.perf_counter() - t0
            slug = "".join(c if c.isalnum() else "_"
                           for c in prompt[:48]).strip("_")
            out_dir = os.path.join(args.export_dir, f"{i:03d}_{slug}")
            if args.num_samples > 1:
                out_dir = os.path.join(out_dir, str(j))
            frames = None
            if group is not None and not args.no_video:
                frames = pipe.render_orbit_video(
                    result["gaussians"], result["dense_cameras"],
                    num_frames=args.num_video_frames, size=args.render_size,
                    group=group)
            if not main:
                continue
            paths, seconds = export_result(result, pipe, prompt, out_dir,
                                           args, frames)
            n = int(result["gaussians"][0].shape[1])
            stages = " ".join(f"{k} {v:.3f}"
                              for k, v in result["timings"].items())
            print(f"[{i + 1}/{len(prompts)}] '{prompt}' sample {j} -> "
                  f"{out_dir} ({dt:.1f}s; seconds by stage: {stages})")
            records.append(dict(out_dir=out_dir, paths=paths,
                                timings=result["timings"],
                                export_seconds=seconds, generate_seconds=dt,
                                n_gaussians=n))
    return records


def view_shard_group(args) -> tuple:
    """``--shard_views``: join the ranks ``torchrun`` started and return
    the world's group and this rank's device; ``(None, None)`` without the
    flag or for a process alone."""
    if not args.shard_views:
        return None, None
    env = init_from_env(args.device)
    if env.backend is None:
        return None, env.device
    if args.num_views % env.world:
        raise SystemExit(f"--shard_views needs num_views ({args.num_views}) "
                         f"divisible by the world size ({env.world})")
    return dist.group.WORLD, env.device


def main(argv=None) -> None:
    joined = dist.is_initialized()
    try:
        run(parse_args(argv))
    finally:
        if dist.is_initialized() and not joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
