"""Training, the counterpart of the repo's ``train.py --synthetic``::

    python -m prometheus_torch.train --stage {mvldm,gsdecoder,trajdit} \\
        --synthetic [--small] [--max_steps N] [--batch_size B] [--seed S] \\
        [--log_every K] [--save_every K] [--ckpt_dir DIR] [--device cpu]
        [--joint_sv] [--render_loss] [--gsdecoder_ckpt DIR]   # mvldm only

Every stage builds its networks at the widths of
``prometheus_tpu/configs`` (or the reduced ``--small`` widths of
``train.py``) with seeded random weights, draws synthetic batches and its
losses' random draws from one ``torch.Generator``, and runs the train step
of ``parallel/train_step.py`` (clipping, AdamW, EMA), printing one JSON line
of metrics every ``--log_every`` steps and at the last step, and appending
it to ``<ckpt_dir>/metrics.jsonl``:

- ``mvldm`` (stage 2, the default): ``MVLDMSystem.multi_view_loss`` on 8
  views at 256^2; ``--joint_sv`` adds ``single_view_loss`` on 2 text-to-image
  images a scene; ``--render_loss`` adds ``rendering_loss`` through a frozen
  GS decoder (random, or the EMA weights of a stage-1 checkpoint of this
  package given by ``--gsdecoder_ckpt``) with LPIPS (random weights). The
  VAE and the CLIP text tower are frozen (out of the optimizer and the EMA);
  the first Adam moment is stored in bf16.
- ``gsdecoder`` (stage 1): ``GSDecoderSystem.loss`` (MSE 1, depth 0.5,
  entropy 0, no LPIPS); every parameter trains, fp32 moments.
- ``trajdit``: ``TrajDiTSystem.loss`` on 29-camera trajectories.

Checkpoints (``checkpoint.py``) go to ``--ckpt_dir`` (default
``./workdir/<stage>_ckpts``) every ``--save_every`` steps and at the end; a
run resumes from the newest one there. It runs on the card unless
``--device cpu`` is given; on the card the networks compute in bf16 with
fp32 parameters (``bf16-mixed``), on the CPU in fp32. Data on disk,
``--val_every``, ``--sp_views``, ``--param_sharding fsdp``,
``--depth_teacher`` and ``--debug`` are not ported yet (ROADMAP.md) and
raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable

import torch

from .checkpoint import (latest_checkpoint, load_ema_weights_,
                         restore_checkpoint, save_checkpoint)
from .models import GSDecoderModel, MVLDMModel, TrajDiTModel
from .models.lpips import make_lpips_fn
from .ops.schedulers import make_schedule
from .parallel import (TrainState, freeze_, frozen_components,
                       init_train_state, make_optimizer, make_train_step)
from .systems import GSDecoderSystem, MVLDMSystem, TrajDiTSystem
from .utils import get_random_cameras, resolve_device
from .weights import init_random_

# the optimizer and EMA of prometheus_tpu/configs/experiment/
# mvldm_vpred_exp.yaml (which train.py reads for every stage)
OPTIM = dict(learning_rate=1e-5, weight_decay=1e-4, betas=(0.9, 0.95),
             grad_clip=1.0, ema_decay=0.9999, accumulate_grad_batches=1,
             steps_per_epoch=1000)
# prometheus_tpu/configs/algorithm/gsdecoder_dit.yaml (network) and
# experiment/gsdecoder_exp.yaml (training); renders use the renderer's tile
# capacity, 1024
GSDECODER_TRAIN = dict(
    OPTIM,
    model=dict(dit_hidden_size=1152, dit_depth=16, dit_num_heads=16,
               vae_ch=128, vae_ch_mult=(1, 2, 4, 4), max_num_images=8),
    image_size=256, render_size=256, batch_size=4,
    num_input_views=4, num_novel_views=4, learning_rate=1e-4,
    adam_mu_dtype=None)
# the reduced widths of train.py's --small (render at the data resolution)
SMALL_GSDECODER_TRAIN = dict(
    GSDECODER_TRAIN,
    model=dict(dit_hidden_size=32, dit_depth=1, dit_num_heads=4, vae_ch=32,
               vae_ch_mult=(1, 2), max_num_images=4),
    image_size=32, render_size=32, num_input_views=2, num_novel_views=2)
# stage 2: algorithm/mvldm.yaml (the SD-2.1 U-Net, CLIP ViT-H text, VAE ch
# 128) and experiment/mvldm_vpred_exp.yaml (training), with train.py's
# defaults for the keys the experiment does not set (images_per_iter,
# lambda_sv, the rendering loss's weights, adam_mu_dtype; LPIPS's weight is
# read from training.lambda_gs_image_lpips, default 1, not from
# losses.lambda_gs_image_lpips)
MVLDM_TRAIN = dict(
    OPTIM,
    model=dict(model_channels=320, channel_mult=(1, 2, 4, 4),
               num_res_blocks=2, num_head_channels=64, context_dim=1024,
               disable_3d_attentions=(1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                      1, 1, 1),
               use_checkpoint=True, clip_layers=23, clip_width=1024,
               vae_ch=128, vae_ch_mult=(1, 2, 4, 4), image_size=256),
    gsdecoder=GSDECODER_TRAIN["model"], image_size=256, batch_size=8,
    num_views=8, num_pred_views=8, images_per_iter=2,
    scheduler_type="vprediction", timestep_type="continuous",
    drop_pose_p=0.1, drop_text_p=0.1, drop_text_p_sv=0.1, lambda_sv=1.0,
    lambda_render=0.1, lambda_render_depth=0.5, lambda_render_lpips=1.0,
    rendering_size=256, adam_mu_dtype=torch.bfloat16)
SMALL_MVLDM_TRAIN = dict(
    MVLDM_TRAIN,
    model=dict(model_channels=32, num_head_channels=16, context_dim=64,
               channel_mult=(1, 2), num_res_blocks=1,
               disable_3d_attentions=(1, 0, 0, 0, 0), use_checkpoint=True,
               clip_layers=2, clip_width=64, vae_ch=32, vae_ch_mult=(1, 2),
               image_size=32),
    gsdecoder=SMALL_GSDECODER_TRAIN["model"], image_size=32, num_views=2,
    num_pred_views=2, rendering_size=32)
# the TrajDiT stage: algorithm/trajdit.yaml's model (the JAX module's
# defaults), 29-camera trajectories, the experiment's optimizer
TRAJDIT_TRAIN = dict(OPTIM, model={}, image_size=256, batch_size=8,
                     adam_mu_dtype=torch.bfloat16)
SMALL_TRAJDIT_TRAIN = dict(
    TRAJDIT_TRAIN, model=dict(hidden_size=32, num_blocks=1, num_heads=4,
                              text_dim=64), image_size=32)
CONFIGS = {("gsdecoder", False): GSDECODER_TRAIN,
           ("gsdecoder", True): SMALL_GSDECODER_TRAIN,
           ("mvldm", False): MVLDM_TRAIN, ("mvldm", True): SMALL_MVLDM_TRAIN,
           ("trajdit", False): TRAJDIT_TRAIN,
           ("trajdit", True): SMALL_TRAJDIT_TRAIN}


def synthetic_mv_batch(generator: torch.Generator, B: int, N: int, img: int,
                       n_in: int, latent: int,
                       device: torch.device | str = "cpu") -> dict:
    """A random stage-1 batch (``train.py::synthetic_mv_batch``): orbit
    cameras shared by the batch, images uniform in [-1, 1], disparities
    uniform in [0.05, 1], and the encoder's standard-normal sampling noise
    ``encode_noise (B, n_in, 4, latent, latent)``."""
    cams = get_random_cameras(N, generator, size=img, device=device)
    u = lambda *s: torch.rand(*s, generator=generator, device=device)
    return {
        "images_mv": u(B, N, 3, img, img) * 2.0 - 1.0,
        "cameras_mv": cams[None].repeat(B, 1, 1),
        "depths_mv": 0.05 + 0.95 * u(B, N, 1, img, img),
        "encode_noise": torch.randn(B, n_in, 4, latent, latent,
                                    generator=generator, device=device),
    }


def synthetic_mvldm_batch(generator: torch.Generator, B: int, N: int,
                          img: int, ctx_dim: int, sv: int = 0,
                          device: torch.device | str = "cpu") -> dict:
    """A random stage-2 batch (``train.py::synthetic_mv_batch``): orbit
    cameras shared by the batch, images uniform in [-1, 1], disparities
    uniform in [0.05, 1], text embeddings ``N(0, 0.02^2)`` and zero
    unconditional ones; with ``sv`` also ``sv`` text-to-image images a
    scene (``images_sv``, ``depths_sv``) and their shared ``text_emb_sv``."""
    cams = get_random_cameras(N, generator, size=img, device=device)
    u = lambda *s: torch.rand(*s, generator=generator, device=device)
    n = lambda *s: torch.randn(*s, generator=generator, device=device)
    out = {"images_mv": u(B, N, 3, img, img) * 2.0 - 1.0,
           "cameras_mv": cams[None].repeat(B, 1, 1),
           "depths_mv": 0.05 + 0.95 * u(B, N, 1, img, img),
           "text_emb": n(B, 77, ctx_dim) * 0.02,
           "uncond_text_emb": torch.zeros(B, 77, ctx_dim, device=device)}
    if sv > 0:
        out["images_sv"] = u(B, sv, 3, img, img) * 2.0 - 1.0
        out["depths_sv"] = 0.05 + 0.95 * u(B, sv, 1, img, img)
        out["text_emb_sv"] = n(B, 77, ctx_dim) * 0.02
    return out


def dummy_sv_camera(image_size: int) -> torch.Tensor:
    """The fixed identity camera of 2-D data (fx = fy = 207.3 at 256^2,
    scaled to ``image_size``)."""
    s = image_size / 256.0
    return torch.tensor([1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 207.3 * s,
                         207.3 * s, 128.0 * s, 128.0 * s, float(image_size),
                         float(image_size)], dtype=torch.float32)


@dataclasses.dataclass(eq=False)
class Trainer:
    """A built run: the system, its train state and step, the loss the
    step differentiates, and the generator its batches and draws come
    from. ``make_batch(trainer)`` draws one synthetic batch."""

    system: object
    state: TrainState
    loss_fn: Callable
    cfg: dict
    batch_size: int
    generator: torch.Generator
    make_batch: Callable
    train_step: Callable = None
    gs_system: GSDecoderSystem | None = None     # mvldm --render_loss

    @property
    def device(self) -> torch.device:
        return next(self.state.model.parameters()).device

    def batch(self) -> dict:
        return self.make_batch(self)

    def step(self, batch: dict | None = None) -> dict:
        return self.train_step(self.state,
                               self.batch() if batch is None else batch)


def _random_module(cls, kwargs: dict, device: torch.device,
                   g: torch.Generator):
    with torch.device("meta"):
        module = cls(**kwargs)
    module.to_empty(device=device)
    init_random_(module, g)
    return module


def _finish(system, model, loss_fn, cfg, batch_size, g, make_batch,
            frozen=None) -> Trainer:
    """Freeze, build the optimizer, the train state and the step."""
    trained = freeze_(model, frozen)
    opt = make_optimizer(trained, cfg["learning_rate"], cfg["weight_decay"],
                         cfg["betas"], mu_dtype=cfg["adam_mu_dtype"])
    trainer = Trainer(system, init_train_state(model, opt), loss_fn, cfg,
                      batch_size or cfg["batch_size"], g, make_batch)
    trainer.train_step = make_train_step(
        lambda batch: trainer.loss_fn(batch), opt,
        ema_decay=cfg["ema_decay"],
        grad_accum=cfg["accumulate_grad_batches"],
        grad_clip=cfg["grad_clip"])
    return trainer


def _compute_dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def build_gsdecoder_trainer(small: bool = False,
                            device: str | torch.device = "cuda",
                            seed: int = 0, batch_size: int | None = None
                            ) -> Trainer:
    """The stage-1 run at flagship (or ``small``) widths with seeded random
    weights on ``device``; bf16-mixed on a card, fp32 on the CPU."""
    device = resolve_device(device)
    cfg = CONFIGS[("gsdecoder", small)]
    g = torch.Generator(device=device).manual_seed(seed)
    model = _random_module(GSDecoderModel, cfg["model"], device, g).train()
    system = GSDecoderSystem(model, render_size=cfg["render_size"],
                             compute_dtype=_compute_dtype(device))
    n_in = cfg["num_input_views"]
    latent = cfg["image_size"] // 2 ** (len(cfg["model"]["vae_ch_mult"]) - 1)

    def loss_fn(batch):
        return system.loss(batch, num_input_views=n_in,
                           render_size=cfg["render_size"])

    def make_batch(tr):
        return synthetic_mv_batch(tr.generator, tr.batch_size,
                                  n_in + cfg["num_novel_views"],
                                  cfg["image_size"], n_in, latent, tr.device)

    return _finish(system, model, loss_fn, cfg, batch_size, g, make_batch)


def build_mvldm_trainer(small: bool = False,
                        device: str | torch.device = "cuda", seed: int = 0,
                        batch_size: int | None = None, joint_sv: bool = False,
                        render_loss: bool = False,
                        gsdecoder_ckpt: str | None = None) -> Trainer:
    """The stage-2 run at flagship (or ``small``) widths with seeded random
    weights on ``device``: the multi-view loss, plus the single-view loss
    with ``joint_sv`` and the rendering loss through a frozen GS decoder
    with ``render_loss``. The VAE and the text tower are frozen; bf16-mixed
    on a card, fp32 on the CPU."""
    device = resolve_device(device)
    cfg = CONFIGS[("mvldm", small)]
    g = torch.Generator(device=device).manual_seed(seed)
    cdt = _compute_dtype(device)
    model = _random_module(MVLDMModel, cfg["model"], device, g).train()
    system = MVLDMSystem(model=model,
                         schedule=make_schedule(cfg["scheduler_type"]),
                         timestep_type=cfg["timestep_type"],
                         num_pred_views=cfg["num_pred_views"],
                         compute_dtype=cdt)
    rs = cfg["rendering_size"]
    gs_system = lpips_fn = None
    if render_loss:
        gs = _random_module(GSDecoderModel, cfg["gsdecoder"], device, g)
        if gsdecoder_ckpt:
            load_ema_weights_(gs, gsdecoder_ckpt)
            print(f"[train] frozen stage-1 decoder from {gsdecoder_ckpt}")
        else:
            print("[train] WARNING: --render_loss without --gsdecoder_ckpt "
                  "renders through a random decoder")
        gs.requires_grad_(False).eval()
        gs_system = GSDecoderSystem(gs, render_size=rs, compute_dtype=cdt)
        if cfg["lambda_render_lpips"]:
            lpips_fn, _ = make_lpips_fn(g, device)
            print("[train] WARNING: rendering-loss LPIPS uses random-init "
                  "weights (the official VGG and linear heads are not in "
                  "the repository)")
    sv_cam = dummy_sv_camera(cfg["image_size"]).to(device)

    def loss_fn(batch):
        loss, metrics, aux = system.multi_view_loss(
            batch, drop_pose_p=cfg["drop_pose_p"],
            drop_text_p=cfg["drop_text_p"], return_aux=True, generator=g)
        if "images_sv" in batch:
            loss_sv, m_sv = system.single_view_loss(
                batch, sv_cam, drop_text_p=cfg["drop_text_p_sv"], generator=g)
            loss = loss + cfg["lambda_sv"] * loss_sv
            metrics.update(m_sv)
        if gs_system is not None:
            loss_r, m_r = system.rendering_loss(
                gs_system, aux["x0_pred"], batch["cameras_mv"],
                batch["images_mv"], batch["depths_mv"], batch["cameras_mv"],
                rendering_size=rs, lambda_lpips=cfg["lambda_render_lpips"],
                lambda_depth=cfg["lambda_render_depth"], lpips_fn=lpips_fn)
            loss = loss + cfg["lambda_render"] * loss_r
            metrics.update(m_r)
        return loss, metrics

    def make_batch(tr):
        return synthetic_mvldm_batch(
            tr.generator, tr.batch_size, cfg["num_views"], cfg["image_size"],
            cfg["model"]["context_dim"],
            sv=cfg["images_per_iter"] if joint_sv else 0, device=tr.device)

    trainer = _finish(system, model, loss_fn, cfg, batch_size, g, make_batch,
                      frozen=frozen_components("vae", "text_encoder"))
    trainer.gs_system = gs_system
    return trainer


def build_trajdit_trainer(small: bool = False,
                          device: str | torch.device = "cuda", seed: int = 0,
                          batch_size: int | None = None) -> Trainer:
    """The TrajDiT stage at flagship (or ``small``) width with seeded random
    weights on ``device``: batches of 29-camera orbit trajectories and text
    embeddings."""
    device = resolve_device(device)
    cfg = CONFIGS[("trajdit", small)]
    g = torch.Generator(device=device).manual_seed(seed)
    model = _random_module(TrajDiTModel, cfg["model"], device, g).train()
    system = TrajDiTSystem(model=model)
    cdt = _compute_dtype(device)

    def loss_fn(batch):
        loss = system.loss(batch["cameras_mv"], batch["text_emb"],
                           generator=g, compute_dtype=cdt)
        return loss, {"loss_traj": loss.detach()}

    def make_batch(tr):
        cams = get_random_cameras(model.num_tokens, tr.generator,
                                  size=cfg["image_size"], device=tr.device)
        return {"cameras_mv": cams[None].repeat(tr.batch_size, 1, 1),
                "text_emb": torch.randn(
                    tr.batch_size, 77, model.y_embedder.in_features,
                    generator=tr.generator, device=tr.device) * 0.02}

    return _finish(system, model, loss_fn, cfg, batch_size, g, make_batch)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--stage", default="mvldm",
                   choices=["mvldm", "gsdecoder", "trajdit"])
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic random batches (the only data source "
                        "ported)")
    p.add_argument("--small", action="store_true",
                   help="reduced model widths (smoke)")
    p.add_argument("--max_steps", type=int, default=-1)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--ckpt_dir", default=None,
                   help="checkpoints and metrics.jsonl (default "
                        "./workdir/<stage>_ckpts); resumes from the newest")
    p.add_argument("--device", default="cuda")
    p.add_argument("--joint_sv", action="store_true",
                   help="mvldm: add the single-view (T2I) loss")
    p.add_argument("--render_loss", action="store_true",
                   help="mvldm: add the rendering loss through the frozen "
                        "stage-1 decoder")
    p.add_argument("--gsdecoder_ckpt", default=None,
                   help="a stage-1 checkpoint of this package (a step_* "
                        "directory, or a directory of them) for "
                        "--render_loss; random decoder if absent")
    # the JAX trainer's other options, refused
    p.add_argument("--val_every", type=int, default=0)
    p.add_argument("--sp_views", action="store_true")
    p.add_argument("--param_sharding", default="replicated",
                   choices=["replicated", "fsdp"])
    p.add_argument("--depth_teacher", default=None,
                   choices=["da2", "luminance"])
    p.add_argument("--debug", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> Trainer:
    args = parse_args(argv)
    if not args.synthetic:
        raise NotImplementedError(
            "training data on disk is not ported yet: pass --synthetic")
    refused = {"--val_every": args.val_every > 0, "--sp_views": args.sp_views,
               "--param_sharding fsdp": args.param_sharding == "fsdp",
               "--depth_teacher": args.depth_teacher is not None,
               "--debug": args.debug}
    for flag, given in refused.items():
        if given:
            raise NotImplementedError(f"{flag} is not ported yet")
    common = dict(small=args.small, device=args.device, seed=args.seed,
                  batch_size=args.batch_size)
    if args.stage == "mvldm":
        trainer = build_mvldm_trainer(
            joint_sv=args.joint_sv, render_loss=args.render_loss,
            gsdecoder_ckpt=args.gsdecoder_ckpt, **common)
    elif args.stage == "gsdecoder":
        trainer = build_gsdecoder_trainer(**common)
    else:
        trainer = build_trajdit_trainer(**common)
    state = trainer.state
    ckpt_dir = args.ckpt_dir or os.path.join("workdir",
                                             f"{args.stage}_ckpts")
    latest = latest_checkpoint(ckpt_dir)
    if latest:
        restore_checkpoint(latest, state)
        print(f"[train] resumed from {latest}")
    os.makedirs(ckpt_dir, exist_ok=True)
    log_path = os.path.join(ckpt_dir, "metrics.jsonl")
    max_steps = (args.max_steps if args.max_steps > 0
                 else trainer.cfg["steps_per_epoch"])
    t_start = time.time()
    for step in range(state.step, max_steps):
        metrics = trainer.step()
        if step % args.log_every == 0 or step == max_steps - 1:
            line = json.dumps({"step": step,
                               "time": round(time.time() - t_start, 2),
                               **{k: float(v) for k, v in metrics.items()}})
            print(line, flush=True)
            with open(log_path, "a") as fp:
                fp.write(line + "\n")
        if args.save_every > 0 and (step + 1) % args.save_every == 0:
            save_checkpoint(ckpt_dir, state, step + 1)
    save_checkpoint(ckpt_dir, state, max_steps)
    print(f"[train] done: {max_steps} steps, ckpts in {ckpt_dir}")
    return trainer


if __name__ == "__main__":
    main()
