"""Split the stage-2 (MV-LDM) train step's time into its parts (the
counterpart of the repo's ``tools/profile_train_step.py``, same arguments
and JSON line, plus ``--device`` and ``--trace``).

The model is built at the flagship widths of ``prometheus_torch/
pipeline.py`` (``--small``: its reduced widths) with seeded random weights,
in float32 with bf16 autocast on the card (the trainer's bf16-mixed), for
a batch of 1 scene x 8 views. Each section is timed on its own: one warm
call, then ``--iters`` calls timed one by one (CUDA events on the card,
the host clock on the CPU), of which the JSON gives the median under the
section's key and the least and the most under ``spread`` (the JAX
tool gives the mean of ``--iters`` calls; the port's step is eager and
host-bound, and one stall of the host moves such a mean).

- ``unet``: the U-Net's forward (``unet_fwd_ms``) and forward + backward
  of a squared-output loss with its blocks checkpointed and not
  (``unet_fwd_bwd_checkpoint_on_ms`` / ``_off_ms``: the JAX tool's remat
  ``full`` / ``dots`` rows; a size that does not fit reads
  ``failed: OutOfMemoryError``);
- ``vae``: the frozen VAE's encode of the step's 2 x 8 images;
- ``loss``: ``multi_view_loss`` forward, and forward + backward;
- ``step``: the whole train step (loss, backward, clip, AdamW with the
  bf16 first moment, EMA; the VAE and the text tower frozen);
- ``loop``: the synthetic batch's generation (``synth_batch_ms``) and a
  step fed by it (``loop_step_ms``).

JAX's ``BENCH_REMAT`` environment variable (an XLA rematerialisation
policy for the loss and step sections) has no counterpart: the port's
U-Net checkpoints whole blocks (``use_checkpoint``), on in the loss and
step sections as in training. ``--trace DIR`` wraps one more step in
``profiling.trace``, whose ``DIR/trace.json`` ``parse_trace`` splits::

    python -m prometheus_torch.tools.profile_train_step [--small] \\
        [--iters 4] [--sections unet,vae,loss,step,loop] [--trace DIR]
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

SECTIONS = ("unet", "vae", "loss", "step", "loop")


def timeit(fn, device: torch.device, iters: int = 4) -> list:
    """ms of each of ``iters`` calls after a warm one, each timed alone."""
    fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def record(out: dict, key: str, val) -> None:
    """Record as it goes, so that a late failure keeps the earlier numbers:
    a list of times as its median, and its least and most under
    ``spread``."""
    if isinstance(val, list):
        out.setdefault("spread", {})[key] = [min(val), max(val)]
        val = statistics.median(val)
    out[key] = val
    print(f"[profile] {key} = {val}", file=sys.stderr, flush=True)


def profile(small: bool = False, iters: int = 4,
            sections=("unet", "vae", "loss", "step"), device="cuda",
            trace: str | None = None, views: int = 8, seed: int = 3) -> dict:
    """Time ``sections`` of the step; returns the JSON dict."""
    from ..models import MVLDMModel
    from ..ops.schedulers import make_schedule
    from ..parallel import (frozen_components, freeze_, init_train_state,
                            make_optimizer, make_train_step)
    from ..pipeline import SMALL_MVLDM
    from ..profiling import TRACE_FILE
    from ..profiling import trace as profiler_trace
    from ..systems import MVLDMSystem
    from ..train import synthetic_mvldm_batch
    from ..utils import resolve_device
    from ..weights import random_module

    device = resolve_device(device)
    sections = set(sections)
    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(seed)
    widths = SMALL_MVLDM if small else dict(image_size=256)
    model = random_module(MVLDMModel, widths, device, g).train()
    cdt = torch.bfloat16 if device.type == "cuda" else torch.float32
    system = MVLDMSystem(model=model, schedule=make_schedule("vprediction"),
                         num_pred_views=views, compute_dtype=cdt)
    out = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "small": small, "batch": 1, "views": views, "iters": iters,
           "parameters": sum(p.numel() for p in model.parameters())}
    record(out, "init_s", time.perf_counter() - t0)
    B, N = 1, views
    img, hw = model.image_size, model.latent_size
    ctx = model.context_dim
    batch = synthetic_mvldm_batch(g, B, N, img, ctx, device=device)

    def autocast():
        return torch.autocast(device_type=device.type, dtype=cdt,
                              enabled=cdt != torch.float32)

    # --- the U-Net alone at the train shapes (B * N frames) ------------
    if "unet" in sections:
        lat = torch.randn(B, N, 9, hw, hw, generator=g, device=device)
        t = torch.zeros(B, N, device=device)
        txt, cams = batch["text_emb"], batch["cameras_mv"]

        def unet_fwd():
            with torch.no_grad(), autocast():
                return model.denoise(lat, txt, t, cams)

        def unet_fwd_bwd():
            model.zero_grad(set_to_none=True)
            with autocast():
                loss = (model.denoise(lat, txt, t, cams).float() ** 2).mean()
            loss.backward()
            return loss

        record(out, "unet_fwd_ms", timeit(unet_fwd, device, iters))
        for flag in (True, False):
            key = f"unet_fwd_bwd_checkpoint_{'on' if flag else 'off'}_ms"
            model.unet.use_checkpoint = flag
            try:
                record(out, key, timeit(unet_fwd_bwd, device, iters))
            except torch.cuda.OutOfMemoryError as e:
                record(out, key, f"failed: {type(e).__name__}")
            model.zero_grad(set_to_none=True)
        model.unet.use_checkpoint = True
        if device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the frozen VAE's encode of the step's 2 x 8 images -------------
    if "vae" in sections:
        imgs2 = torch.cat([batch["images_mv"], batch["images_mv"]], 1)

        def vae_enc():
            with torch.no_grad(), autocast():
                return model.encode_image(imgs2)

        record(out, "vae_encode_16imgs_ms", timeit(vae_enc, device, iters))

    # --- the loss, forward and forward + backward ------------------------
    def loss_fn(b):
        return system.multi_view_loss(b, generator=g)

    if "loss" in sections:
        def loss_fwd():
            with torch.no_grad():
                return loss_fn(batch)[0]

        def loss_fwd_bwd():
            model.zero_grad(set_to_none=True)
            loss = loss_fn(batch)[0]
            loss.backward()
            return loss

        record(out, "loss_fwd_ms", timeit(loss_fwd, device, iters))
        record(out, "loss_fwd_bwd_ms", timeit(loss_fwd_bwd, device, iters))
        model.zero_grad(set_to_none=True)

    # --- the whole step and the loop that feeds it -----------------------
    if sections & {"step", "loop"} or trace:
        trained = freeze_(model, frozen_components("vae", "text_encoder"))
        opt = make_optimizer(trained, learning_rate=1e-5,
                             mu_dtype=torch.bfloat16)
        state = init_train_state(model, opt)
        step_fn = make_train_step(loss_fn, opt)
        if "step" in sections:
            record(out, "full_step_ms", timeit(
                lambda: step_fn(state, batch)["loss"], device, iters))
        if "loop" in sections:
            def synth():
                return synthetic_mvldm_batch(g, B, N, img, ctx, device=device)

            record(out, "synth_batch_ms", timeit(synth, device, iters))
            record(out, "loop_step_ms", timeit(
                lambda: step_fn(state, synth())["loss"], device, iters))
        if trace:
            step_fn(state, batch)
            with profiler_trace(trace):
                step_fn(state, batch)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            record(out, "trace", f"{trace}/{TRACE_FILE}")
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--sections", default="unet,vae,loss,step",
                    help="comma list of unet,vae,loss,step,loop (JAX's "
                         "BENCH_REMAT has no counterpart: see above)")
    ap.add_argument("--trace", default=None,
                    help="write a profiling.trace of one step here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    unknown = set(args.sections.split(",")) - set(SECTIONS)
    if unknown:
        ap.error(f"unknown sections {sorted(unknown)}")
    out = profile(args.small, args.iters, args.sections.split(","),
                  args.device, args.trace)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
