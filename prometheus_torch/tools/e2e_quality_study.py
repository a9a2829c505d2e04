"""End-to-end quality with trained weights, text -> latents -> 3D gaussians
-> renders (the counterpart of the repo's ``tools/e2e_quality_study.py``,
same arguments and JSON, plus ``--device``).

Extends ``sampler_quality_study`` (latent and image PSNR) through the whole
production path: overfit a tiny MV-LDM and a tiny GS decoder on fixed
synthetic scenes, then sample latents from the text, decode images and
depths, lift them to gaussians, render them at the scene's cameras and
report the renders' PSNR against the scene (on the novel cameras, which
the decoder's training supervises; all cameras as a second number). An
"oracle" row feeds the true images and depths straight into the decoder:
the decoder's ceiling, so that the difference is the sampling's cost. The
upstream counterpart is the rendering-loss evaluation of its MV-LDM
system (sample -> GS decoder -> render -> image metrics).

Draws come from ``torch.Generator``s seeded like the JAX tool's keys (0
for both trainings, 7 for the sampler's noise)::

    python -m prometheus_torch.tools.e2e_quality_study [--train_steps 2000] \\
        [--gs_train_steps 1200] [--out e2e_quality_study.json]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .sampler_quality_study import (fixed_scene_batch, overfit_mvldm, psnr,
                                    rounded)

# the tiny GS decoder the study overfits (max_num_images: the views)
TINY_GSDECODER = dict(dit_hidden_size=32, dit_depth=1, dit_num_heads=4,
                      vae_ch=32, vae_ch_mult=(1, 2))
# the samplers of the end-to-end rows
SAMPLERS = (("euler", 100), ("dpmpp_2m", 30))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--train_steps", type=int, default=2000,
                    help="stage-1 (MV-LDM) overfit steps")
    ap.add_argument("--gs_train_steps", type=int, default=1200,
                    help="stage-2 (GSDecoder) overfit steps")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--views", type=int, default=4,
                    help="views per scene; first half feed stage 2")
    ap.add_argument("--img", type=int, default=32)
    ap.add_argument("--guidance_scale", type=float, default=1.0,
                    help="1.0 = pure conditional (the overfit target)")
    ap.add_argument("--out", default="e2e_quality_study.json")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def overfit_gsdecoder(batch: dict, steps: int, lr: float, img: int, n_in: int,
                      device, log_every: int = 200):
    """Build the tiny GS decoder (seed 0) and overfit it on ``batch``'s
    first ``n_in`` views (the rest are the novel views it renders), no EMA.
    Returns ``(system, last novel-view PSNR, seconds)``."""
    from ..models import GSDecoderModel
    from ..parallel import init_train_state, make_optimizer, make_train_step
    from ..systems import GSDecoderSystem
    from ..weights import random_module

    N = batch["images_mv"].shape[1]
    g = torch.Generator(device=device).manual_seed(0)
    model = random_module(GSDecoderModel,
                          dict(TINY_GSDECODER, max_num_images=N), device, g)
    system = GSDecoderSystem(model=model.train(), render_size=img)
    hw = img // 2 ** (len(TINY_GSDECODER["vae_ch_mult"]) - 1)
    B = batch["images_mv"].shape[0]

    def loss_fn(b):
        b = dict(b, encode_noise=torch.randn(B, n_in, 4, hw, hw, generator=g,
                                             device=device))
        return system.loss(b, num_input_views=n_in, render_size=img)

    opt = make_optimizer(model.parameters(), learning_rate=lr,
                         weight_decay=0.0)
    state = init_train_state(model, opt)
    step_fn = make_train_step(loss_fn, opt)
    t0 = time.perf_counter()
    last = 0.0
    for step in range(steps):
        metrics = step_fn(state, batch)
        if step % log_every == 0 or step == steps - 1:
            last = float(metrics["psnr_mv"])
            print(f"[stage2] step {step}: novel-view psnr {last:.2f} dB",
                  flush=True)
    model.eval()
    return system, last, time.perf_counter() - t0


def main(argv=None) -> dict:
    args = parse_args(argv)
    from ..utils import resolve_device

    device = resolve_device(args.device)
    img, N = args.img, args.views
    n_in = N // 2
    batch = fixed_scene_batch(list(range(args.scenes)), n_views=N, img=img,
                              device=device)
    result = {"scenes": args.scenes, "views": N, "img": args.img,
              "guidance_scale": args.guidance_scale}

    # ---- stage 1: overfit the tiny MV-LDM -------------------------------
    mv_system, curve, mv_s = overfit_mvldm(
        batch, args.train_steps, args.lr, "vprediction", img, device, 200,
        tag="stage1")
    result["stage1"] = {"train_steps": args.train_steps,
                        "train_seconds": round(mv_s, 1),
                        "final_eval_loss": curve[-1]["eval_loss"]}

    # ---- stage 2: overfit the tiny GS decoder ---------------------------
    gs_system, last_psnr, gs_s = overfit_gsdecoder(
        batch, args.gs_train_steps, args.lr, img, n_in, device)
    result["stage2"] = {"train_steps": args.gs_train_steps,
                        "train_seconds": round(gs_s, 1),
                        "final_novel_view_psnr_db": rounded(last_psnr)}

    # ---- end to end: text -> latents -> images + depths -> 3DGS -> render
    hw = mv_system.model.latent_size

    @torch.no_grad()
    def render_from(images, depths, cams):
        """The decoder's lift of the first half of the views, rendered at
        all of the scene's cameras (the encoder's mode)."""
        out = gs_system.inference(images[:, :n_in], depths[:, :n_in],
                                  cams[:, :n_in], cams)
        return out["images_nv_pred"]

    def e2e(sampler, steps, scene):
        cams = batch["cameras_mv"][scene:scene + 1]
        text = batch["text_emb"][scene:scene + 1]
        lat = mv_system.sample(
            cams, text, torch.zeros_like(text),
            torch.Generator(device=device).manual_seed(7),
            num_inference_steps=steps, guidance_scale=args.guidance_scale,
            guidance_type="joint", cfg_rescale=0.0, latent_hw=hw,
            sampler=sampler)
        with torch.no_grad():
            imgs, deps = mv_system.decode_images_and_depths(lat)
        return render_from(imgs, deps, cams)

    def scored(r, scene):
        """PSNR on the novel cameras (what the decoder's training
        supervises), and on all cameras."""
        gt = batch["images_mv"][scene:scene + 1].cpu().numpy()
        r = r.float().cpu().numpy()
        return psnr(r[:, n_in:], gt[:, n_in:]), psnr(r, gt)

    rows = []
    for sampler, steps in SAMPLERS:
        nv, allv = zip(*(scored(e2e(sampler, steps, s), s)
                         for s in range(args.scenes)))
        rows.append({"sampler": sampler, "steps": steps,
                     "render_psnr_db": rounded(sum(nv) / len(nv)),
                     "render_psnr_all_views_db":
                         rounded(sum(allv) / len(allv)),
                     "per_scene": [rounded(v) for v in nv]})
        print(f"[e2e] {sampler}@{steps}: novel-view render PSNR "
              f"{rows[-1]['render_psnr_db']} dB", flush=True)

    # oracle: the true images and depths through the decoder only
    nv, allv = zip(*(scored(render_from(
        batch["images_mv"][s:s + 1], batch["depths_mv"][s:s + 1],
        batch["cameras_mv"][s:s + 1]), s) for s in range(args.scenes)))
    result["oracle_stage2_render_psnr_db"] = rounded(sum(nv) / len(nv))
    result["oracle_stage2_all_views_db"] = rounded(sum(allv) / len(allv))
    result["e2e"] = rows
    print(f"[e2e] oracle (GT inputs): "
          f"{result['oracle_stage2_render_psnr_db']} dB", flush=True)
    with open(args.out, "w") as fp:
        json.dump(result, fp, indent=2)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
