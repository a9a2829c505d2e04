"""Low-step sampler quality with trained weights (the counterpart of the
repo's ``tools/sampler_quality_study.py``, same arguments and JSON, plus
``--device``).

Overfits a tiny MV-LDM on K fixed scenes (a real optimisation run: the
loss curve is part of the result), then holds each sampler's deterministic
ODE solution against a fine-step Euler reference (the same noise, the same
guidance) in latent and decoded-image PSNR: trained weights give the
sampler the smooth denoiser it meets in production. The upstream ladder
compared against is its 100-step Euler.

Draws come from ``torch.Generator``s seeded like the JAX tool's keys (0
for training, 123 for the fixed evaluation loss, 7 for the sampler's
noise; scene ``s``'s cameras 100 + s and text 200 + s), so a run repeats
itself but not the JAX tool's numbers::

    python -m prometheus_torch.tools.sampler_quality_study \\
        [--train_steps 1500] [--schedule vprediction|edm] \\
        [--out sampler_quality_study.json]
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import time

import numpy as np
import torch

# the samplers held against the fine Euler reference
CANDIDATES = (("euler", 100), ("euler", 50), ("euler", 30), ("dpmpp_2m", 30),
              ("dpmpp_2m", 16), ("dpmpp_2m", 100))
# the tiny MV-LDM both studies overfit
TINY_MVLDM = dict(model_channels=32, num_head_channels=16, context_dim=64,
                  channel_mult=(1, 2), num_res_blocks=1,
                  disable_3d_attentions=(1, 0, 0, 0, 0), use_checkpoint=False,
                  clip_layers=2, clip_width=64, vae_ch=32, vae_ch_mult=(1, 2))


def fixed_scene_batch(scene_ids, n_views: int = 2, img: int = 32,
                      ctx: int = 64, cameras=None, text=None,
                      device="cpu") -> dict:
    """Deterministic structured scenes (sinusoid textures keyed by the
    scene id, rolled across the views; fixed cameras and captions): a fixed
    dataset the tiny model can overfit. ``cameras (B, N, 18)`` and ``text
    (B, 77, ctx)`` are drawn from generators seeded ``100 + s`` and ``200 +
    s`` unless given."""
    yy, xx = torch.meshgrid(torch.arange(img, dtype=torch.float32),
                            torch.arange(img, dtype=torch.float32),
                            indexing="ij")
    yy, xx = yy / img * 6.28318, xx / img * 6.28318
    images = []
    for s in scene_ids:
        base = torch.stack([
            torch.sin(yy * (1 + s % 3) + s) * torch.cos(xx * (1 + s % 2)),
            torch.sin((yy + xx) * (1 + s % 4) * 0.5),
            torch.cos(yy * 0.7 + xx * (1 + s % 5) * 0.6)], 0)
        images.append(torch.stack([torch.roll(base, 3 * v, dims=-1)
                                   for v in range(n_views)], 0))
    images = torch.stack(images, 0).to(device)           # (B, N, 3, H, W)
    if cameras is None:
        from ..utils import get_random_cameras

        cameras = torch.stack([get_random_cameras(
            n_views, torch.Generator().manual_seed(100 + s), size=img)
            for s in scene_ids], 0)
    if text is None:
        text = torch.stack([torch.randn(
            77, ctx, generator=torch.Generator().manual_seed(200 + s)) * 0.2
            for s in scene_ids], 0)
    text = torch.as_tensor(text, dtype=torch.float32).to(device)
    return {
        "images_mv": images,
        "cameras_mv": torch.as_tensor(cameras, dtype=torch.float32).to(
            device),
        "depths_mv": 0.5 + 0.5 * images[:, :, :1] ** 2,
        "text_emb": text,
        "uncond_text_emb": torch.zeros_like(text),
    }


def psnr(a, b) -> float:
    """PSNR of ``a`` against ``b`` over ``b``'s value range, in dB."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    rng = max(b.max() - b.min(), 1e-8)
    return float(10 * np.log10(rng * rng / mse))


def overfit_mvldm(batch: dict, steps: int, lr: float, schedule: str,
                  img: int, device, log_every: int, tag: str = "train"):
    """Build the tiny MV-LDM (seed 0) and overfit it on ``batch`` with
    AdamW (no weight decay), the EMA at 0.999 and no text or pose dropout.
    Returns ``(system, curve, seconds)``: a system around the EMA
    weights, and the evaluation loss (fixed draws, seed 123) every
    ``log_every`` steps and at the last."""
    from ..models import MVLDMModel
    from ..ops.schedulers import make_schedule
    from ..parallel import (full_ema_params, init_train_state,
                            make_optimizer, make_train_step)
    from ..systems import MVLDMSystem
    from ..weights import random_module

    N = batch["images_mv"].shape[1]
    g = torch.Generator(device=device).manual_seed(0)
    model = random_module(MVLDMModel, dict(TINY_MVLDM, image_size=img),
                          device, g).train()
    system = MVLDMSystem(model=model, schedule=make_schedule(schedule),
                         num_pred_views=N)

    def loss_fn(b, generator=g):
        return system.multi_view_loss(b, drop_pose_p=0.0, drop_text_p=0.0,
                                      generator=generator)

    opt = make_optimizer(model.parameters(), learning_rate=lr,
                         weight_decay=0.0)
    state = init_train_state(model, opt)
    step_fn = make_train_step(loss_fn, opt, ema_decay=0.999)

    def eval_loss(m_sys):
        with torch.no_grad():
            ev = torch.Generator(device=device).manual_seed(123)
            return float(m_sys.multi_view_loss(
                batch, drop_pose_p=0.0, drop_text_p=0.0, generator=ev)[0])

    curve = []
    t0 = time.perf_counter()
    for step in range(steps):
        step_fn(state, batch)
        if step % log_every == 0 or step == steps - 1:
            loss = eval_loss(system)
            curve.append({"step": step, "eval_loss": loss})
            print(f"[{tag}] step {step}: eval_loss {loss:.5f}", flush=True)
    seconds = time.perf_counter() - t0
    ema = copy.deepcopy(model).eval()
    with torch.no_grad():
        for name, value in full_ema_params(ema, state.ema_params).items():
            ema.get_parameter(name).copy_(value)
    ema_system = copy.copy(system)
    ema_system.model = ema
    return ema_system, curve, seconds


def rounded(x: float, nd: int = 2) -> float | None:
    return round(x, nd) if math.isfinite(x) else None


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--train_steps", type=int, default=1500)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="vprediction",
                    choices=["vprediction", "edm"])
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--views", type=int, default=2)
    ap.add_argument("--img", type=int, default=32)
    ap.add_argument("--ref_steps", type=int, default=400)
    ap.add_argument("--guidance_scale", type=float, default=7.5)
    ap.add_argument("--out", default="sampler_quality_study.json")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from ..utils import resolve_device

    device = resolve_device(args.device)
    img, N = args.img, args.views
    batch = fixed_scene_batch(list(range(args.scenes)), n_views=N, img=img,
                              device=device)
    system, curve, train_s = overfit_mvldm(
        batch, args.train_steps, args.lr, args.schedule, img, device, 50)
    model = system.model

    # --- the samplers: deterministic ODE solutions from one seed --------
    cams = batch["cameras_mv"][:1]
    text = batch["text_emb"][:1]
    uncond = batch["uncond_text_emb"][:1]
    hw = model.latent_size

    def run(sampler, steps):
        lat = system.sample(
            cams, text, uncond,
            torch.Generator(device=device).manual_seed(7),
            num_inference_steps=steps, guidance_scale=args.guidance_scale,
            guidance_type="joint", cfg_rescale=0.0, latent_hw=hw,
            sampler=sampler)
        with torch.no_grad():
            imgs = model.decode_latent(lat[:, :, :4])
        return lat.float().cpu().numpy(), imgs.float().cpu().numpy()

    print(f"[study] reference: euler@{args.ref_steps}", flush=True)
    ref_lat, ref_img = run("euler", args.ref_steps)
    rows = []
    for sampler, steps in CANDIDATES:
        lat, im = run(sampler, steps)
        rows.append({"sampler": sampler, "steps": steps,
                     "latent_psnr_db": rounded(psnr(lat, ref_lat)),
                     "image_psnr_db": rounded(psnr(im, ref_img))})
        print(f"[study] {sampler}@{steps}: latent "
              f"{rows[-1]['latent_psnr_db']} dB, image "
              f"{rows[-1]['image_psnr_db']} dB", flush=True)

    # the overfit's check: the decoded reference resembles the scene
    overfit_psnr = psnr(ref_img, batch["images_mv"][:1].cpu().numpy())
    result = {
        "schedule": args.schedule,
        "train_steps": args.train_steps,
        "train_seconds": round(train_s, 1),
        "loss_first": curve[0]["eval_loss"],
        "loss_last": curve[-1]["eval_loss"],
        "loss_curve": curve,
        "ref_sampler": f"euler@{args.ref_steps}",
        "decoded_vs_train_scene_psnr_db": rounded(overfit_psnr),
        "samplers": rows,
    }
    with open(args.out, "w") as fp:
        json.dump(result, fp, indent=2)
    print(json.dumps({k: v for k, v in result.items() if k != "loss_curve"}))
    return result


if __name__ == "__main__":
    main()
