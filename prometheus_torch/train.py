"""Training, the counterpart of the repo's ``train.py``::

    python -m prometheus_torch.train --stage {mvldm,gsdecoder,trajdit} \\
        [--synthetic | --config CFG --override data_root=DIR ... \\
         [--depth_teacher {da2,luminance}]] \\
        [--small] [--max_steps N] [--batch_size B] [--seed S] \\
        [--log_every K] [--save_every K] [--val_every K] [--ckpt_dir DIR] \\
        [--device cpu] [--debug] [--param_sharding {replicated,fsdp}]
        [--joint_sv] [--render_loss] [--gsdecoder_ckpt DIR]   # mvldm only
        [--sp_views]                                          # mvldm only
    torchrun --nproc_per_node=N -m prometheus_torch.train ...

Every stage builds its networks at the widths of
``prometheus_torch/configs`` (or the reduced ``--small`` widths of
``train.py``) with seeded random weights, draws its synthetic batches
(from disk, stage 1's encoder noise) and its losses' random draws from one
``torch.Generator``, and runs the train step
of ``parallel/train_step.py`` (clipping, AdamW, EMA), printing one JSON line
of metrics every ``--log_every`` steps and at the last step, and appending
it to ``<ckpt_dir>/metrics.jsonl``:

- ``mvldm`` (stage 2, the default): ``MVLDMSystem.multi_view_loss`` on 8
  views at 256^2; ``single_view_loss`` on the text-to-image images of a
  batch that carries them (``--joint_sv`` adds 2 a scene to a synthetic
  batch); ``--render_loss`` adds ``rendering_loss`` through a frozen
  GS decoder (random, or the EMA weights of a stage-1 checkpoint of this
  package given by ``--gsdecoder_ckpt``) with LPIPS (random weights). The
  VAE and the CLIP text tower are frozen (out of the optimizer and the EMA);
  the first Adam moment is stored in bf16.
- ``gsdecoder`` (stage 1): ``GSDecoderSystem.loss`` (MSE 1, depth 0.5,
  entropy 0, no LPIPS); every parameter trains, fp32 moments.
- ``trajdit``: ``TrajDiTSystem.loss`` on 29-camera trajectories
  (``--synthetic`` only: from disk the JAX trainer has no text embeddings
  for it either).

With ``--synthetic`` the batches are random tensors made on the device.
Without it they come from image files on disk: the composed config
(``config.py``; ``--config``, default ``prometheus_torch/configs/
config.yaml``, and ``--override group=stem key=value ...``) names the
dataset tree (``datasets/``), which the loader reads in worker processes.
The trainer reads from it every key that ``train.py`` reads
(``config_settings``: ``seed``, ``output_dir``, the optimizer, EMA,
precision, resume and loss keys of ``training``, the experiment's
schedule, and without ``--small`` the networks of ``algorithm`` and
``gsdecoder``, the GS decoder's ``use_cross_view_dit`` and
``use_ema_norm`` variants among them), taking the dicts below where it
sets none; ``--seed`` and ``--batch_size`` win. Its
``lpips_weights`` (a torch LPIPS + VGG16 checkpoint) gives
``--render_loss``'s LPIPS its weights. It tokenizes the captions, embeds
them with the frozen CLIP text tower (stage 2), and makes the
pseudo-depths with the ``--depth_teacher``: ``da2`` (the default) is
Depth-Anything-V2-Small in float32 with the HF weights the config's
``depth_weights`` names (without them the run exits: a random teacher
would supervise on garbage), ``luminance`` is ``clip(mean_c(images) * 0.5
+ 0.5, 0, 1)``. ``--synthetic`` batches carry their own depths and use
neither.

``--val_every K`` writes a snapshot every K steps with the EMA weights,
under ``<ckpt_dir>/snapshots/``: mvldm a 20-step sample of the batch's
first scene (``val_mv_images`` grid and ``val_mv_views`` GIF), gsdecoder
the first scene's novel views (``val_nvs_renders``: ground truth,
prediction and depth rows), trajdit a 20-step trajectory
(``val_traj.png``); a failing snapshot is printed and the run goes on.
``--debug`` turns on ``torch.autograd``'s anomaly detection and checks
every batch for NaN and Inf before its step.

Checkpoints (``checkpoint.py``) go to ``--ckpt_dir`` (default
``<output_dir>/<stage>_ckpts``, ``./workdir`` without a config) every
``--save_every`` steps and at the end; a run resumes from the newest one
there (unless the config's ``training.resume_from_checkpoint`` is not
``latest``). It runs on the card unless
``--device cpu`` is given; on the card the networks compute in bf16 with
fp32 parameters (``bf16-mixed``), on the CPU in fp32.

Under ``torchrun`` the ranks join over ``nccl``, each on
``cuda:$LOCAL_RANK`` (``gloo`` with ``--device cpu``), on a mesh
(``parallel/dist.py``): the hybrid ``("dcn", "data")`` mesh when the ranks
span more than one node, a flat ``("data",)`` one otherwise.
``--batch_size`` (and the config's ``training.batch_size``) is per rank:
the global batch is per rank x world x ``accumulate_grad_batches``. Every
rank builds the same weights from the seed. A synthetic global batch is
drawn from the shared seed and each rank keeps its slice; from disk each
rank's loader reads its own slice (seeded ``seed + rank``). The losses'
per-scene draws are the global batch's, sliced, so N ranks compute what
one process computes, and the gradients are averaged. ``--sp_views``
(plain ``mvldm`` only, the views divisible by the world size) splits each
scene's views over the ranks instead: every rank holds the whole batch
(not multiplied by the world size), ``multi_view_loss_view_sharded``
gathers K and V at the U-Net's joint sites, and the ranks' gradients are
summed. ``--param_sharding fsdp`` shards the optimizer state and the EMA
(``parallel.ZeroShards``) inside a node. Rank 0 alone logs, writes
snapshots and writes the (whole) checkpoints.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Callable

import torch

from .checkpoint import (latest_checkpoint, load_ema_weights_,
                         restore_checkpoint, save_checkpoint)
from .config import DEFAULT_CONFIG, load_config
from .models import GSDecoderModel, MVLDMModel, TrajDiTModel, make_depth_fn
from .models.lpips import make_lpips_fn
from .ops.schedulers import make_schedule
from .parallel import (TrainState, ZeroShards, freeze_, frozen_components,
                       init_train_state, make_optimizer, make_train_step)
from .parallel.dist import (barrier, broadcast_, data_group, get_rank,
                            init_from_env, is_main_process, local_batch_size,
                            make_hybrid_mesh, make_mesh, shard_batch,
                            shard_batch_per_host, shard_group, world_size)
from .systems import GSDecoderSystem, MVLDMSystem, TrajDiTSystem
from .systems.traj_dit_system import TOKEN_DIM
from .utils import get_random_cameras, resolve_device
from .utils.nan_guard import assert_finite, enable_nan_debug
from .weights import random_module

# --sp_views over more than one rank: rank r draws its views' noise from a
# generator seeded seed + SP_VIEW_SEED * (r + 1)
SP_VIEW_SEED = 1000003
# the optimizer and EMA of prometheus_tpu/configs/experiment/
# mvldm_vpred_exp.yaml (which train.py reads for every stage)
OPTIM = dict(learning_rate=1e-5, weight_decay=1e-4, betas=(0.9, 0.95),
             grad_clip=1.0, ema_decay=0.9999, accumulate_grad_batches=1,
             steps_per_epoch=1000, precision="bf16-mixed",
             resume_from_checkpoint="latest", output_dir="./workdir",
             num_workers=4)
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
    high_noise=False, drop_pose_p=0.1, drop_text_p=0.1, drop_text_p_sv=0.1,
    lambda_sv=1.0,
    lambda_render=0.1, lambda_render_depth=0.5, lambda_render_lpips=1.0,
    rendering_size=256, adam_mu_dtype=torch.bfloat16, lpips_weights=None)
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


@dataclasses.dataclass(frozen=True)
class Parallel:
    """How a run spreads over its ranks: the process group batches shard
    and gradients reduce over (``group``; None runs alone, and the world's
    group is ``dist.group.WORLD``), the group FSDP shards over
    (``shard_group``; None: ``group``), and the modes. This rank's place
    is read from ``group``."""

    group: object = None
    shard_group: object = None
    sp_views: bool = False
    fsdp: bool = False

    @property
    def active(self) -> bool:
        """Over a process group (at any world size)."""
        return self.group is not None

    @property
    def rank(self) -> int:
        return get_rank(self.group) if self.active else 0

    @property
    def world(self) -> int:
        return world_size(self.group) if self.active else 1

    @property
    def reduce(self) -> str | None:
        """The train step's gradient reduction."""
        if not self.active:
            return None
        return "sum" if self.sp_views else "mean"

    @property
    def rows(self) -> tuple | None:
        """Data parallel over more than one rank: ``(rank, world)``, this
        rank's place in the global batch."""
        if self.sp_views or self.world == 1:
            return None
        return self.rank, self.world

    def shard(self, global_batch: dict, micro_batches: int) -> dict:
        """This rank's slice of a synthetic global batch."""
        if self.rows is None:
            return global_batch
        return shard_batch(global_batch, self.group, micro_batches)


@dataclasses.dataclass(eq=False)
class Trainer:
    """A built run: the system, its train state and step, the loss the
    step differentiates, and the generator its batches and draws come
    from. ``make_batch(trainer)`` gives one batch on the device: a
    synthetic one, or the next from disk through ``feed``."""

    system: object
    state: TrainState
    loss_fn: Callable
    cfg: dict
    batch_size: int
    generator: torch.Generator
    make_batch: Callable
    train_step: Callable = None
    gs_system: GSDecoderSystem | None = None     # mvldm --render_loss
    stage: str = ""
    feed: DiskFeed | None = None
    parallel: Parallel = Parallel()

    @property
    def device(self) -> torch.device:
        return next(self.state.model.parameters()).device

    def batch(self) -> dict:
        return self.make_batch(self)

    def step(self, batch: dict | None = None) -> dict:
        return self.train_step(self.state,
                               self.batch() if batch is None else batch)


def _finish(stage, system, model, loss_fn, cfg, batch_size, g, make_batch,
            frozen=None, parallel: Parallel | None = None) -> Trainer:
    """Freeze, build the optimizer (over ``ZeroShards`` slices with
    ``--param_sharding fsdp``), the train state and the step."""
    par = parallel or Parallel()
    trained = freeze_(model, frozen)
    sharding = None
    if par.fsdp:
        sharding = ZeroShards([(n, p) for n, p in model.named_parameters()
                               if p.requires_grad],
                              par.group if par.shard_group is None
                              else par.shard_group)
        trained = list(sharding.shards.values())
    opt = make_optimizer(trained, cfg["learning_rate"], cfg["weight_decay"],
                         cfg["betas"], mu_dtype=cfg["adam_mu_dtype"])
    trainer = Trainer(system, init_train_state(model, opt, sharding),
                      loss_fn, cfg, batch_size or cfg["batch_size"], g,
                      make_batch, stage=stage, parallel=par)
    trainer.train_step = make_train_step(
        lambda batch: trainer.loss_fn(batch), opt,
        ema_decay=cfg["ema_decay"],
        grad_accum=cfg["accumulate_grad_batches"],
        grad_clip=cfg["grad_clip"], group=par.group, reduce=par.reduce,
        sharding=sharding)
    return trainer


def _compute_dtype(device: torch.device, cfg: dict) -> torch.dtype:
    """bf16 on a card at ``bf16-mixed`` precision, fp32 otherwise."""
    return (torch.bfloat16 if device.type == "cuda"
            and "bf16" in cfg["precision"] else torch.float32)


def build_gsdecoder_trainer(small: bool = False,
                            device: str | torch.device = "cuda",
                            seed: int = 0, batch_size: int | None = None,
                            overrides: dict | None = None,
                            parallel: Parallel | None = None) -> Trainer:
    """The stage-1 run at flagship (or ``small``) widths with seeded random
    weights on ``device``; bf16-mixed on a card, fp32 on the CPU.
    ``overrides`` replace keys of the stage's settings dict; ``parallel``
    spreads it over ranks."""
    par = parallel or Parallel()
    device = resolve_device(device)
    cfg = dict(CONFIGS[("gsdecoder", small)], **(overrides or {}))
    g = torch.Generator(device=device).manual_seed(seed)
    model = random_module(GSDecoderModel, cfg["model"], device, g).train()
    system = GSDecoderSystem(model, render_size=cfg["render_size"],
                             compute_dtype=_compute_dtype(device, cfg))
    n_in = cfg["num_input_views"]
    latent = cfg["image_size"] // 2 ** (len(cfg["model"]["vae_ch_mult"]) - 1)

    def loss_fn(batch):
        return system.loss(batch, num_input_views=n_in,
                           render_size=cfg["render_size"])

    def make_batch(tr):
        return par.shard(synthetic_mv_batch(
            tr.generator, tr.batch_size * par.world,
            n_in + cfg["num_novel_views"], cfg["image_size"], n_in, latent,
            tr.device), cfg["accumulate_grad_batches"])

    return _finish("gsdecoder", system, model, loss_fn, cfg, batch_size, g,
                   make_batch, parallel=par)


def build_mvldm_trainer(small: bool = False,
                        device: str | torch.device = "cuda", seed: int = 0,
                        batch_size: int | None = None, joint_sv: bool = False,
                        render_loss: bool = False,
                        gsdecoder_ckpt: str | None = None,
                        overrides: dict | None = None,
                        parallel: Parallel | None = None) -> Trainer:
    """The stage-2 run at flagship (or ``small``) widths with seeded random
    weights on ``device``: the multi-view loss, plus the single-view loss
    on a batch with ``images_sv`` (``joint_sv`` puts them in the synthetic
    batches) and the rendering loss through a frozen GS decoder with
    ``render_loss``. The VAE and the text tower are frozen; bf16-mixed on a
    card, fp32 on the CPU. ``overrides`` replace keys of the stage's
    settings dict; ``parallel`` spreads it over ranks (``--sp_views``: the
    views of each scene)."""
    par = parallel or Parallel()
    device = resolve_device(device)
    cfg = dict(CONFIGS[("mvldm", small)], **(overrides or {}))
    g = torch.Generator(device=device).manual_seed(seed)
    # per-view draws of --sp_views: one generator a rank (the shared one
    # when it runs alone, which makes it the plain step)
    view_g = g if par.world == 1 else torch.Generator(
        device=device).manual_seed(seed + SP_VIEW_SEED * (par.rank + 1))
    cdt = _compute_dtype(device, cfg)
    model = random_module(MVLDMModel, cfg["model"], device, g).train()
    system = MVLDMSystem(model=model,
                         schedule=make_schedule(cfg["scheduler_type"],
                                                high_noise=cfg["high_noise"]),
                         timestep_type=cfg["timestep_type"],
                         num_pred_views=cfg["num_pred_views"],
                         compute_dtype=cdt)
    rs = cfg["rendering_size"]
    gs_system = lpips_fn = None
    if render_loss:
        gs = random_module(GSDecoderModel, cfg["gsdecoder"], device, g)
        if gsdecoder_ckpt:
            load_ema_weights_(gs, gsdecoder_ckpt)
            print(f"[train] frozen stage-1 decoder from {gsdecoder_ckpt}")
        else:
            print("[train] WARNING: --render_loss without --gsdecoder_ckpt "
                  "renders through a random decoder")
        gs.requires_grad_(False).eval()
        gs_system = GSDecoderSystem(gs, render_size=rs, compute_dtype=cdt)
        if cfg["lambda_render_lpips"]:
            lpips_fn, _ = make_lpips_fn(g, device,
                                        weights_path=cfg["lpips_weights"])
            if not cfg["lpips_weights"]:
                print("[train] WARNING: rendering-loss LPIPS uses "
                      "random-init weights (set lpips_weights for the "
                      "converted official VGG and linear heads)")
    sv_cam = dummy_sv_camera(cfg["image_size"]).to(device)

    def loss_fn(batch):
        if par.sp_views:
            return system.multi_view_loss_view_sharded(
                par.group, batch, generator=g, view_generator=view_g,
                drop_pose_p=cfg["drop_pose_p"],
                drop_text_p=cfg["drop_text_p"])
        loss, metrics, aux = system.multi_view_loss(
            batch, drop_pose_p=cfg["drop_pose_p"],
            drop_text_p=cfg["drop_text_p"], return_aux=True, generator=g,
            rows=par.rows)
        if "images_sv" in batch:
            loss_sv, m_sv = system.single_view_loss(
                batch, sv_cam, drop_text_p=cfg["drop_text_p_sv"], generator=g,
                rows=par.rows)
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
        return par.shard(synthetic_mvldm_batch(
            tr.generator, tr.batch_size * (1 if par.sp_views else par.world),
            cfg["num_views"], cfg["image_size"], cfg["model"]["context_dim"],
            sv=cfg["images_per_iter"] if joint_sv else 0, device=tr.device),
            cfg["accumulate_grad_batches"])

    trainer = _finish("mvldm", system, model, loss_fn, cfg, batch_size, g,
                      make_batch,
                      frozen=frozen_components("vae", "text_encoder"),
                      parallel=par)
    trainer.gs_system = gs_system
    return trainer


def build_trajdit_trainer(small: bool = False,
                          device: str | torch.device = "cuda", seed: int = 0,
                          batch_size: int | None = None,
                          parallel: Parallel | None = None) -> Trainer:
    """The TrajDiT stage at flagship (or ``small``) width with seeded random
    weights on ``device``: batches of 29-camera orbit trajectories and text
    embeddings; ``parallel`` spreads it over ranks."""
    par = parallel or Parallel()
    device = resolve_device(device)
    cfg = CONFIGS[("trajdit", small)]
    g = torch.Generator(device=device).manual_seed(seed)
    model = random_module(TrajDiTModel, cfg["model"], device, g).train()
    system = TrajDiTSystem(model=model)
    cdt = _compute_dtype(device, cfg)

    def loss_fn(batch):
        t = noise = None
        if par.rows is not None:         # the global batch's draws, sliced
            r, W = par.rows
            B, dev = batch["cameras_mv"].shape[0], batch["cameras_mv"].device
            mine = slice(r * B, (r + 1) * B)
            t = torch.randint(0, system.schedule.num_train_timesteps,
                              (B * W,), generator=g, device=dev)[mine]
            noise = torch.randn((B * W, model.num_tokens, TOKEN_DIM),
                                generator=g, device=dev)[mine]
        loss = system.loss(batch["cameras_mv"], batch["text_emb"], t=t,
                           noise=noise, generator=g, compute_dtype=cdt)
        return loss, {"loss_traj": loss.detach()}

    def make_batch(tr):
        B = tr.batch_size * par.world
        cams = get_random_cameras(model.num_tokens, tr.generator,
                                  size=cfg["image_size"], device=tr.device)
        return par.shard({"cameras_mv": cams[None].repeat(B, 1, 1),
                          "text_emb": torch.randn(
                              B, 77, model.y_embedder.in_features,
                              generator=tr.generator, device=tr.device)
                          * 0.02}, cfg["accumulate_grad_batches"])

    return _finish("trajdit", system, model, loss_fn, cfg, batch_size, g,
                   make_batch, parallel=par)


class DiskFeed:
    """Batches from disk: the loader's next host batch (a new epoch when
    one ends), converted to the loss's batch on the device by ``convert``,
    whose pseudo-depths come from ``depth_fn`` (``(B, N, 3, H, W)`` ->
    ``(B, N, 1, H, W)``, read at each call). ``wait_s`` holds the host
    seconds the last batch waited on the loader. ``close()`` ends the
    loader's worker processes."""

    def __init__(self, loader, convert: Callable, depth_fn: Callable):
        if len(loader) == 0:
            raise ValueError(
                f"the dataset's {len(loader.dataset)} items make no batch "
                f"of {loader.batch_sampler.batch_size}")
        self.loader, self.convert, self.depth_fn = loader, convert, depth_fn
        self.wait_s = 0.0
        self._it = None

    def next_raw(self) -> dict:
        t0 = time.perf_counter()
        while True:
            if self._it is None:
                self._it = iter(self.loader)
            try:
                raw = next(self._it)
                break
            except StopIteration:
                self._it = None
        self.wait_s = time.perf_counter() - t0
        return raw

    def __call__(self, trainer: Trainer) -> dict:
        return self.convert(self.next_raw())

    def close(self) -> None:
        """End the workers now (the iterator would end them when
        collected)."""
        if self._it is not None and hasattr(self._it, "_shutdown_workers"):
            self._it._shutdown_workers()
        self._it = None


def luminance_depth(images: torch.Tensor) -> torch.Tensor:
    """The luminance pseudo-disparity of images in [-1, 1]: ``clip(mean_c *
    0.5 + 0.5, 0, 1)``, ``(..., 3, H, W)`` -> ``(..., 1, H, W)``."""
    return torch.clamp(images.mean(dim=-3, keepdim=True) * 0.5 + 0.5,
                       0.0, 1.0)


# the composed config's keys that train.py reads, each with the stage
# setting it sets and how its value converts: training.<key> (all stages,
# then stage 2's losses), experiment.<key> (stage 2's schedule) and the
# networks' keys (without --small)
_TRAINING_KEYS = {
    "learning_rate": ("learning_rate", float),
    "weight_decay": ("weight_decay", float),
    "betas": ("betas", lambda v: tuple(float(b) for b in v)),
    "ema_decay": ("ema_decay", float),
    "accumulate_grad_batches": ("accumulate_grad_batches", int),
    "steps_per_epoch": ("steps_per_epoch", int),
    "num_workers": ("num_workers", int),
    "precision": ("precision", str),
    "resume_from_checkpoint": ("resume_from_checkpoint", str),
    "adam_mu_dtype": ("adam_mu_dtype",
                      lambda v: torch.bfloat16 if str(v) == "bf16" else None),
}
_MVLDM_LOSS_KEYS = {
    "drop_pose_p": ("drop_pose_p", float),
    "text_to_3d_drop_text_p": ("drop_text_p", float),
    "text_to_2d_drop_text_p": ("drop_text_p_sv", float),
    "lambda_sv": ("lambda_sv", float),
    "lambda_render": ("lambda_render", float),
    "lambda_render_depth": ("lambda_render_depth", float),
    "lambda_gs_image_lpips": ("lambda_render_lpips", float),
}
_SCHEDULE_KEYS = {"scheduler_type": ("scheduler_type", str),
                  "timestep_type": ("timestep_type", str),
                  "high_noise_level": ("high_noise", bool)}
_MVLDM_NETWORK_KEYS = {k: (k, int) for k in (
    "image_size", "latent_channel", "extra_latent_channel", "model_channels",
    "num_res_blocks", "num_head_channels", "context_dim", "clip_layers",
    "clip_width")} | {"channel_mult": ("channel_mult", tuple),
                      "disable_3d_attentions": ("disable_3d_attentions",
                                                tuple),
                      "use_checkpoint": ("use_checkpoint", bool)}
_GS_NETWORK_KEYS = {"latent_channel": ("latent_channel", int),
                    "extra_latent_channel": ("extra_latent_channel", int),
                    "use_cross_view_dit": ("use_cross_view_dit", bool),
                    "use_ema_norm": ("use_ema_norm", bool)}
_DIT_KEYS = {"hidden_size": ("dit_hidden_size", int),
             "depth": ("dit_depth", int),
             "num_heads": ("dit_num_heads", int),
             "max_num_images": ("max_num_images", int)}


def _taken(src, keys: dict) -> dict:
    return {name: conv(src[k]) for k, (name, conv) in keys.items()
            if k in (src or {})}


def config_settings(cfg, stage: str, small: bool) -> dict:
    """The stage's settings that the composed config sets: every key that
    ``train.py`` reads (``training``'s optimizer, EMA, precision, resume,
    workers and, for stage 2, loss keys; the batch, which holds
    ``accumulate_grad_batches`` micro-batches; the views of stage 1, which
    ``--small`` keeps at 2 + 2, and of stage 2 with its single-view images;
    ``output_dir``; the experiment's schedule; and without ``--small`` the
    networks of ``algorithm`` (stage 2, and the image size of both stages)
    and ``gsdecoder`` (stage 1, and stage 2's rendering decoder), its
    ``use_cross_view_dit`` and ``use_ema_norm`` among them)."""
    base = CONFIGS[(stage, small)]
    tr = cfg.get("training", {})
    out = _taken(tr, _TRAINING_KEYS)
    if "output_dir" in cfg:
        out["output_dir"] = str(cfg["output_dir"])
    accum = out.get("accumulate_grad_batches", base["accumulate_grad_batches"])
    out["batch_size"] = int(tr.get("batch_size", base["batch_size"])) * accum
    if stage == "gsdecoder" and not small:
        for k in ("num_input_views", "num_novel_views"):
            if k in tr:
                out[k] = int(tr[k])
    if stage == "mvldm":
        if cfg.get("lpips_weights"):
            out["lpips_weights"] = str(cfg["lpips_weights"])
        out.update(_taken(tr, _MVLDM_LOSS_KEYS))
        out.update(_taken(cfg.get("experiment"), _SCHEDULE_KEYS))
        if "num_input_views" in tr:
            out["num_views"] = int(tr["num_input_views"]) + int(
                tr.get("num_novel_views", 0))
        if "single_view_num" in tr:
            out["images_per_iter"] = int(tr["single_view_num"])
        if "num_pred_views" in tr and not small:
            out["num_pred_views"] = int(tr["num_pred_views"])
    if small:
        return out
    net = _taken((cfg.get("algorithm") or {}).get("network"),
                 _MVLDM_NETWORK_KEYS)
    if "image_size" in net:
        out["image_size"] = net["image_size"]
    if stage == "mvldm" and net:
        out["model"] = dict(base["model"], **net)
    gnet = (cfg.get("gsdecoder") or {}).get("network")
    if gnet:
        gs = dict(_taken(gnet, _GS_NETWORK_KEYS),
                  **_taken(gnet.get("cross_view_dit"), _DIT_KEYS))
        key = "model" if stage == "gsdecoder" else "gsdecoder"
        out[key] = dict(base[key], **gs)
    return out


def depth_teacher(name: str, cfg, device: torch.device) -> Callable:
    """The pseudo-depth function of ``--depth_teacher``: ``da2`` with the
    config's ``depth_weights`` (the run exits without them), or
    ``luminance``."""
    if name == "luminance":
        return luminance_depth
    if not cfg.get("depth_weights"):
        raise SystemExit(
            "--depth_teacher da2 needs converted DepthAnything-V2 weights "
            "(set depth_weights in the config); a randomly initialized "
            "teacher would supervise on garbage. Use --depth_teacher "
            "luminance for smoke runs.")
    return make_depth_fn(weights_path=cfg["depth_weights"], device=device)


def attach_disk_feed(trainer: Trainer, cfg, seed: int,
                     depth_fn: Callable) -> DiskFeed:
    """Build the config's training dataset and its loader, and make the
    trainer's batches come from it: the rank's batch to the device
    (``shard_batch_per_host``: pinned, ``non_blocking``), ``depth_fn``'s
    depths (the feed's ``depth_fn``), and for stage 2 the frozen CLIP
    tower's embeddings of the captions (``text_emb``), of the empty
    prompt (``uncond_text_emb``) and of each single-view caption
    (``text_emb_sv``, ``(B, M, 77, D)``); stage 1 draws the encoder's
    sampling noise from the trainer's generator."""
    from .datasets import build_dataset, common_kwargs_from_group, make_loader
    from .models.clip_text import CLIPTokenizer

    tc, dev, system = trainer.cfg, trainer.device, trainer.system
    par = trainer.parallel
    ds_cfg = dict(cfg["dataset"])
    dataset = build_dataset(dict(ds_cfg["train"]),
                            common_kwargs_from_group(ds_cfg))
    # data parallel: each rank's loader reads its slice of the global
    # batch, seeded seed + rank; --sp_views: every rank reads the whole
    # batch (its views split in the loss), seeded alike
    dp = not par.sp_views
    loader = make_loader(
        dataset, local_batch_size(trainer.batch_size * par.world, par.group)
        if dp else trainer.batch_size, num_workers=tc["num_workers"],
        seed=seed + par.rank if dp else seed, pin_memory=dev.type == "cuda")
    img = tc["image_size"]

    def images_of(raw, key):
        images = raw[key]
        if images.shape[-1] != img or images.shape[-2] != img:
            # attention sequences grow 4x an octave: fail with the fix
            raise ValueError(
                f"dataset serves {images.shape[-2]}x{images.shape[-1]} "
                f"images but the model expects {img}x{img}: set the "
                "config's image_size (--override image_size=...) to match")
        return images

    if trainer.stage == "mvldm":
        tokenizer = CLIPTokenizer(cfg.get("bpe_vocab"))
        model = system.model
        uncond = {}

        def embed(texts) -> torch.Tensor:
            ids = torch.from_numpy(tokenizer(list(texts))).long().to(dev)
            with torch.no_grad(), system._autocast(dev):
                return model.encode_text(ids).float()

        def convert(raw):
            raw = shard_batch_per_host(raw, dev)
            images = images_of(raw, "images_mv")
            B = images.shape[0]
            if "emb" not in uncond:
                uncond["emb"] = embed([""])
            out = {"images_mv": images,
                   "cameras_mv": raw["cameras_mv"],
                   "depths_mv": feed.depth_fn(images),
                   "text_emb": embed(raw["text_mv"]),
                   "uncond_text_emb": uncond["emb"].expand(
                       (B,) + uncond["emb"].shape[1:])}
            if not dp and par.active:
                # --sp_views: every rank's views of a scene take one
                # caption embedding (the fallback tokenizer's ids differ
                # between processes)
                out["uncond_text_emb"] = out["uncond_text_emb"].contiguous()
                broadcast_([out["text_emb"], out["uncond_text_emb"]],
                           par.group)
            if "images_sv" in raw:
                images_sv = images_of(raw, "images_sv")
                M = images_sv.shape[1]
                emb = embed([t for per_item in raw["text_sv"]
                             for t in per_item])
                out.update(images_sv=images_sv,
                           depths_sv=feed.depth_fn(images_sv),
                           text_emb_sv=emb.reshape((B, M) + emb.shape[1:]))
            return out
    else:
        n_in = tc["num_input_views"]
        latent = img // 2 ** (len(tc["model"]["vae_ch_mult"]) - 1)

        def convert(raw):
            raw = shard_batch_per_host(raw, dev)
            images = images_of(raw, "images_mv")
            return {"images_mv": images,
                    "cameras_mv": raw["cameras_mv"],
                    "depths_mv": feed.depth_fn(images),
                    "encode_noise": torch.randn(
                        images.shape[0], n_in, 4, latent, latent,
                        generator=trainer.generator, device=dev)}

    feed = DiskFeed(loader, convert, depth_fn)
    trainer.make_batch, trainer.feed = feed, feed
    return feed


@contextlib.contextmanager
def ema_weights(trainer: Trainer, ema: dict | None = None):
    """The model with its EMA weights (``ema``, whole, or the state's) in
    place of the trained ones, in eval mode; the live weights and mode come
    back on exit."""
    model = trainer.state.model
    ema = trainer.state.ema_params if ema is None else ema
    named = dict(model.named_parameters())
    live = {n: named[n].data for n in ema}
    was_training = model.training
    try:
        for n, value in ema.items():
            named[n].data = value
        model.eval()
        yield model
    finally:
        for n, data in live.items():
            named[n].data = data
        model.train(was_training)


@torch.no_grad()
def validation_snapshot(trainer: Trainer, step: int, batch: dict,
                        logger, ema: dict | None = None) -> None:
    """The snapshot of ``train.py``'s ``--val_every``, with the EMA weights
    and a generator seeded by ``step``: mvldm samples the batch's first
    scene in 20 steps (``val_mv_images`` grid, ``val_mv_views`` GIF);
    gsdecoder renders its novel views from its input views
    (``val_nvs_renders``: ground truth, prediction and depth rows); trajdit
    samples a trajectory in 20 steps (``snapshots/<step>_val_traj.png``)."""
    from .utils.image import colorize_depth, make_grid, postprocess_image

    system, dev = trainer.system, trainer.device
    g = torch.Generator(device=dev).manual_seed(step)
    with ema_weights(trainer, ema) as model:
        if trainer.stage == "mvldm":
            with system._autocast(dev):
                lat = system.sample(
                    batch["cameras_mv"][:1], batch["text_emb"][:1],
                    batch["uncond_text_emb"][:1], generator=g,
                    num_inference_steps=20, latent_hw=model.latent_size)
                imgs, _ = system.decode_images_and_depths(lat)
            views = postprocess_image(imgs[0].float().cpu().numpy())
            logger.log_image("val_mv_images", make_grid(views), step)
            logger.log_gif("val_mv_views", list(views), step,
                           duration_ms=200)
        elif trainer.stage == "gsdecoder":
            n_in = trainer.cfg["num_input_views"]
            out = system.inference(
                batch["images_mv"][:1, :n_in], batch["depths_mv"][:1, :n_in],
                batch["cameras_mv"][:1, :n_in], batch["cameras_mv"][:1, n_in:])
            rows = [postprocess_image(batch["images_mv"][0, n_in:]
                                      .float().cpu().numpy()),
                    postprocess_image(out["images_nv_pred"][0]
                                      .float().cpu().numpy()),
                    colorize_depth(out["depths_nv_pred"][0, :, 0]
                                   .float().cpu().numpy())]
            logger.log_grid("val_nvs_renders", [list(r) for r in rows], step)
        else:
            from .utils.visualization import plot_cameras_png

            cams = system.inference(batch["text_emb"][:1], generator=g,
                                    num_inference_steps=20, image_size=256)
            plot_cameras_png(os.path.join(logger.log_dir, "snapshots",
                                          f"{step:09d}_val_traj.png"),
                             cams[0].float().cpu().numpy())


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--stage", default="mvldm",
                   choices=["mvldm", "gsdecoder", "trajdit"])
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic random batches (without it: the "
                        "config's dataset on disk)")
    p.add_argument("--config", default=DEFAULT_CONFIG,
                   help="root config of the data on disk")
    p.add_argument("--override", nargs="*", default=[],
                   help="group=stem or key=value, e.g. data_root=DIR "
                        "training.batch_size=4 dataset=gsdecoder_dataset")
    p.add_argument("--small", action="store_true",
                   help="reduced model widths (smoke)")
    p.add_argument("--max_steps", type=int, default=-1)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--seed", type=int, default=None,
                   help="default: the config's seed from disk, else 0")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--val_every", type=int, default=0,
                   help="every N steps: a snapshot with the EMA weights "
                        "under <ckpt_dir>/snapshots/")
    p.add_argument("--ckpt_dir", default=None,
                   help="checkpoints and metrics.jsonl (default "
                        "./workdir/<stage>_ckpts); resumes from the newest")
    p.add_argument("--device", default="cuda")
    p.add_argument("--joint_sv", action="store_true",
                   help="mvldm: add the single-view (T2I) loss to synthetic "
                        "batches (from disk it runs whenever the dataset "
                        "serves images_sv)")
    p.add_argument("--render_loss", action="store_true",
                   help="mvldm: add the rendering loss through the frozen "
                        "stage-1 decoder")
    p.add_argument("--gsdecoder_ckpt", default=None,
                   help="a stage-1 checkpoint of this package (a step_* "
                        "directory, or a directory of them) for "
                        "--render_loss; random decoder if absent")
    p.add_argument("--depth_teacher", default="da2",
                   choices=["da2", "luminance"],
                   help="pseudo-depth of data on disk: DepthAnything-V2 "
                        "(the config's depth_weights) or a cheap luminance "
                        "proxy (no weights / smoke runs)")
    p.add_argument("--debug", action="store_true",
                   help="anomaly detection in the backward and a NaN / Inf "
                        "check of every batch")
    p.add_argument("--sp_views", action="store_true",
                   help="mvldm: split each scene's views over the ranks "
                        "(K/V gathered at the joint attention sites; the "
                        "batch is not multiplied by the world size)")
    p.add_argument("--param_sharding", default="replicated",
                   choices=["replicated", "fsdp"],
                   help="fsdp: shard the optimizer state and the EMA of "
                        "parameters of 2^16 elements or more over the "
                        "ranks of a node")
    return p.parse_args(argv)


def build_parallel(args, cfg, device) -> tuple[Parallel, torch.device]:
    """Join the ranks ``torchrun`` started (a process alone joins none),
    build the mesh (hybrid over more than one node) and check
    ``--sp_views`` as the JAX trainer does. Returns the ``Parallel`` and
    this rank's device."""
    env = init_from_env(device)
    mesh = None
    if env.backend is not None:
        kind = env.device.type
        mesh = (make_hybrid_mesh(kind) if env.num_nodes > 1
                else make_mesh(kind))
    par = Parallel(group=data_group(mesh), shard_group=shard_group(mesh),
                   sp_views=args.sp_views,
                   fsdp=args.param_sharding == "fsdp")
    if args.sp_views:
        if args.stage != "mvldm" or args.joint_sv or args.render_loss:
            raise SystemExit("--sp_views supports the plain mvldm stage "
                             "(no --joint_sv / --render_loss yet)")
        n = (config_settings(cfg, "mvldm", args.small).get("num_views")
             if cfg else None) or CONFIGS[("mvldm", args.small)]["num_views"]
        if n % env.world:
            raise SystemExit(f"--sp_views needs num views ({n}) divisible "
                             f"by the device count ({env.world})")
    return par, env.device


def build_trainer(args) -> Trainer:
    """The trainer ``args`` ask for, its batches synthetic or from disk,
    over the ranks ``torchrun`` started."""
    cfg = depth_fn = None
    if not args.synthetic:
        if args.stage == "trajdit":
            raise ValueError(
                "--stage trajdit trains on --synthetic batches only: from "
                "disk its loss would need text embeddings, which the JAX "
                "trainer does not make outside --stage mvldm either")
        cfg = load_config(args.config, args.override)
    par, device = build_parallel(args, cfg, args.device)
    if cfg:
        depth_fn = depth_teacher(args.depth_teacher, cfg, device)
    seed = args.seed if args.seed is not None else int(
        cfg.get("seed", 0) if cfg else 0)
    common = dict(small=args.small, device=device, seed=seed,
                  batch_size=args.batch_size,
                  overrides=config_settings(cfg, args.stage, args.small)
                  if cfg else None, parallel=par)
    if args.stage == "mvldm":
        trainer = build_mvldm_trainer(
            joint_sv=args.joint_sv, render_loss=args.render_loss,
            gsdecoder_ckpt=args.gsdecoder_ckpt, **common)
    elif args.stage == "gsdecoder":
        trainer = build_gsdecoder_trainer(**common)
    else:
        common.pop("overrides")
        trainer = build_trajdit_trainer(**common)
    if cfg:
        attach_disk_feed(trainer, cfg, seed, depth_fn)
    return trainer


def run(args, trainer: Trainer) -> Trainer:
    """Train ``trainer`` as ``args`` ask: resume, step, log, snapshot and
    checkpoint; the loader's workers end with the run."""
    from .logging_utils import MetricLogger

    state = trainer.state
    main = is_main_process()
    ckpt_dir = args.ckpt_dir or os.path.join(trainer.cfg["output_dir"],
                                             f"{args.stage}_ckpts")
    latest = latest_checkpoint(ckpt_dir)
    if latest and trainer.cfg["resume_from_checkpoint"] == "latest":
        restore_checkpoint(latest, state)
        if main:
            print(f"[train] resumed from {latest}")
    barrier()                # every rank has read before any rank writes
    if main:
        os.makedirs(ckpt_dir, exist_ok=True)
    log_path = os.path.join(ckpt_dir, "metrics.jsonl")
    max_steps = (args.max_steps if args.max_steps > 0
                 else trainer.cfg["steps_per_epoch"])
    logger = MetricLogger(ckpt_dir) if args.val_every > 0 and main else None
    snapshots = args.val_every > 0
    anomaly = torch.is_anomaly_enabled()
    if args.debug:
        enable_nan_debug()
    t_start = time.time()
    try:
        for step in range(state.step, max_steps):
            batch = trainer.batch()
            if args.debug:
                assert_finite(batch, f"batch@step{step}")
            metrics = trainer.step(batch)
            if main and (step % args.log_every == 0
                         or step == max_steps - 1):
                line = json.dumps({"step": step,
                                   "time": round(time.time() - t_start, 2),
                                   **{k: float(v)
                                      for k, v in metrics.items()}})
                print(line, flush=True)
                with open(log_path, "a") as fp:
                    fp.write(line + "\n")
            if snapshots and (step + 1) % args.val_every == 0:
                ema = state.full_ema()       # every rank (FSDP gathers)
                try:
                    if logger is not None:
                        validation_snapshot(trainer, step + 1, batch, logger,
                                            ema=ema)
                except Exception as e:   # a snapshot never ends the run
                    print(f"[train] validation snapshot failed: {e!r}")
            if args.save_every > 0 and (step + 1) % args.save_every == 0:
                save_checkpoint(ckpt_dir, state, step + 1)
    finally:
        if trainer.feed is not None:
            trainer.feed.close()
        enable_nan_debug(anomaly)
    save_checkpoint(ckpt_dir, state, max_steps)
    if main:
        print(f"[train] done: {max_steps} steps, ckpts in {ckpt_dir}")
    return trainer


def main(argv=None) -> Trainer:
    import torch.distributed as dist

    args = parse_args(argv)
    joined = dist.is_initialized()
    try:
        return run(args, build_trainer(args))
    finally:
        if dist.is_initialized() and not joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
