"""MV-SDS++ refine iterations at growing U-Net widths (the counterpart of
the repo's ``tools/refine_width_study.py``, same arguments and JSON, plus
``--device``).

Runs ``MultiviewSDSPPRefiner.refine_gaussians`` with an MV-LDM of the
flagship structure (SD-2.1 depth, channel_mult 1/2/4/4, 256^2 renders, the
flagship gaussian count) whose ``model_channels`` (and head and VAE
widths) are scaled by each ``--widths`` fraction, bf16, seeded random
weights; below width 1.0 the text tower is cut to 2 layers of 64 (it only
supplies embeddings the refiner holds constant). Records each width's
build seconds and each iteration's seconds (the host clock to the end of
the iteration's queued work, read where the refiner logs it); the JAX
tool's compile-unit split has no counterpart (nothing is compiled per
width). The upstream counterpart is its MV-SDS++ refiner's train step and
refine loop::

    python -m prometheus_torch.tools.refine_width_study \\
        [--widths 0.25 0.5 1.0] [--iters 4] [--gaussians 524288] \\
        [--out refine_width_study.json]
"""
from __future__ import annotations

import argparse
import json
import math
import time

import torch


def build_mvldm(frac: float, *, flagship_clip: bool, device,
                seed: int = 0):
    """A bf16 MV-LDM system of flagship structure with width-scaled
    channels (seeded random weights). Returns ``(system, build_s)``."""
    from ..models import MVLDMModel
    from ..ops.schedulers import make_schedule
    from ..systems import MVLDMSystem
    from ..weights import random_module

    kw = dict(model_channels=int(320 * frac),
              num_head_channels=int(64 * frac), vae_ch=int(128 * frac),
              image_size=256, use_checkpoint=False)
    if not flagship_clip:
        kw.update(clip_layers=2, clip_width=64, context_dim=int(1024 * frac))
    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(seed)
    model = random_module(MVLDMModel, kw, device, g).to(
        torch.bfloat16).eval().requires_grad_(False)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    system = MVLDMSystem(model=model, schedule=make_schedule("vprediction"),
                         num_pred_views=4)
    return system, time.perf_counter() - t0


def synthetic_gaussians(generator: torch.Generator, n: int, device):
    """A scene of trained statistics: points uniform in a ball of radius 2,
    bimodal opacity, lognormal scales of about a pixel's footprint, unit
    quaternions (``ops/gaussian/quality.py``'s realistic regime)."""
    def normal(*s):
        return torch.randn(*s, generator=generator, device=device)

    def uni(*s):
        return torch.rand(*s, generator=generator, device=device)

    d = normal(1, n, 3)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    xyz = d * uni(1, n, 1) ** (1.0 / 3.0) * 2.0
    feats = uni(1, n, 1, 3)
    opacity = torch.where(uni(1, n, 1) > 0.5, 0.9, 0.05) * (
        0.5 + 0.5 * uni(1, n, 1))
    scales = torch.exp(normal(1, n, 3) * 0.5 - 5.0)
    rots = normal(1, n, 4)
    rots = rots / torch.linalg.norm(rots, dim=-1, keepdim=True)
    return (xyz, feats, opacity, scales, rots)


class _IterationClock(list):
    """The refiner's ``log``: stamps each iteration's end (after the card
    finishes its queued work)."""

    def __init__(self, device):
        super().__init__()
        self.device = device
        self.stamps = [time.perf_counter()]

    def append(self, entry):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stamps.append(time.perf_counter())
        super().append(entry)


def run_width(frac: float, *, iters: int, n_gauss: int, views: int,
              img_size: int, device) -> dict:
    """One width: build, refine ``iters`` iterations, time them."""
    from ..refiners import MultiviewSDSPPRefiner
    from ..utils import get_random_cameras

    system, init_s = build_mvldm(frac, flagship_clip=frac >= 1.0,
                                 device=device)
    model = system.model

    def encode_fn(images):          # (V, 3, H, W) -> (V, 4, h, w)
        return model.encode_image(images[None].to(torch.bfloat16))[0]

    def decode_fn(latents):         # (V, 4, h, w) -> (V, 3, H, W)
        return model.decode_latent(latents[None].to(torch.bfloat16))[0].float()

    refiner = MultiviewSDSPPRefiner(
        encode_fn=encode_fn, decode_fn=decode_fn, denoise_fn=None,
        mvldm_system=system, total_iterations=iters,
        densification_interval=10 * iters, num_views=views,
        img_size=img_size)
    g = torch.Generator(device=device).manual_seed(1)
    gaussians = synthetic_gaussians(g, n_gauss, device)
    ctx = model.context_dim
    text = (torch.randn(1, 77, ctx, generator=g, device=device)
            * 0.02).to(torch.bfloat16)
    uncond = torch.zeros(1, 77, ctx, device=device, dtype=torch.bfloat16)
    dense = get_random_cameras(16, g, size=img_size, device=device)[None]
    clock = _IterationClock(device)
    t0 = time.perf_counter()
    out = refiner.refine_gaussians(gaussians, text, uncond, dense,
                                   generator=g, log=clock)
    total_s = time.perf_counter() - t0
    per_iter = [b - a for a, b in zip(clock.stamps, clock.stamps[1:])]
    rest = sorted(per_iter[1:])
    losses = [float(e["loss"]) for e in clock]
    return {
        "width_frac": frac,
        "model_channels": int(320 * frac),
        "init_s": init_s,
        "total_s": total_s,
        "iter1_s": per_iter[0] if per_iter else None,
        "steady_iter_s": rest[len(rest) // 2] if rest else None,
        "per_iter_s": per_iter,
        "losses": losses,
        "iters": iters,
        "n_gaussians": n_gauss,
        "views_per_iter": views,
        "img_size": img_size,
        "finite": bool(torch.isfinite(out[0]).all())
        and all(math.isfinite(v) for v in losses),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--widths", type=float, nargs="*",
                    default=[0.25, 0.5, 1.0])
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--gaussians", type=int, default=524288)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--img_size", type=int, default=256)
    ap.add_argument("--out", type=str, default="refine_width_study.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..utils import resolve_device

    device = resolve_device(args.device)
    results = {"widths": [], "flagship_ok": False}
    for frac in args.widths:
        print(f"[study] width_frac={frac} "
              f"(model_channels={int(320 * frac)})...", flush=True)
        try:
            r = run_width(frac, iters=args.iters, n_gauss=args.gaussians,
                          views=args.views, img_size=args.img_size,
                          device=device)
            results["widths"].append(r)
            if frac >= 1.0 and r["finite"]:
                results["flagship_ok"] = True
            print(f"[study] width_frac={frac}: init {r['init_s']:.1f}s, "
                  f"iter1 {r['iter1_s']:.3f}s, steady "
                  f"{r['steady_iter_s']}s", flush=True)
        except Exception as e:  # noqa: BLE001 - the failure is the record
            results["widths"].append(
                {"width_frac": frac, "error": f"{type(e).__name__}: {e}"})
            print(f"[study] width_frac={frac} FAILED: {e}", flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        with open(args.out, "w") as fp:
            json.dump(results, fp, indent=2)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
