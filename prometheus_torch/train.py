"""Stage-1 (GS decoder) training, the counterpart of the repo's
``train.py --stage gsdecoder --synthetic``::

    python -m prometheus_torch.train --stage gsdecoder --synthetic \\
        --max_steps N [--small] [--device cpu] [--batch_size B] [--seed S]

It builds the GS decoder at the widths of
``prometheus_tpu/configs/algorithm/gsdecoder_dit.yaml`` (or the reduced
``--small`` widths of ``train.py``) with seeded random weights, draws
synthetic batches from a ``torch.Generator``, and runs the train step of
``parallel/train_step.py`` on ``GSDecoderSystem.loss`` (MSE 1, depth 0.5,
entropy 0, no LPIPS), printing one JSON line of metrics per logged step. It
runs on the card unless ``--device cpu`` is given; on the card the networks
compute in bf16 with fp32 parameters (``bf16-mixed``), on the CPU in fp32.
Other stages, data on disk, ``--render_loss`` and checkpoints are not
ported yet (ROADMAP.md) and raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from .models import GSDecoderModel
from .parallel import (TrainState, init_train_state, make_optimizer,
                       make_train_step)
from .systems import GSDecoderSystem
from .utils import get_random_cameras, resolve_device
from .weights import init_random_

# prometheus_tpu/configs/algorithm/gsdecoder_dit.yaml (network) and
# experiment/gsdecoder_exp.yaml (training); renders use the renderer's tile
# capacity, 1024
GSDECODER_TRAIN = dict(
    model=dict(dit_hidden_size=1152, dit_depth=16, dit_num_heads=16,
               vae_ch=128, vae_ch_mult=(1, 2, 4, 4), max_num_images=8),
    image_size=256, render_size=256, batch_size=4,
    num_input_views=4, num_novel_views=4, learning_rate=1e-4,
    weight_decay=1e-4, betas=(0.9, 0.95), grad_clip=1.0, ema_decay=0.9999,
    accumulate_grad_batches=1, steps_per_epoch=1000)
# the reduced widths of train.py's --small (render at the data resolution)
SMALL_GSDECODER_TRAIN = dict(
    GSDECODER_TRAIN,
    model=dict(dit_hidden_size=32, dit_depth=1, dit_num_heads=4, vae_ch=32,
               vae_ch_mult=(1, 2), max_num_images=4),
    image_size=32, render_size=32, num_input_views=2, num_novel_views=2)


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


@dataclasses.dataclass(eq=False)
class GSDecoderTrainer:
    """A built stage-1 run: the system, its train state and step, and the
    generator its synthetic batches come from."""

    system: GSDecoderSystem
    state: TrainState
    train_step: object
    cfg: dict
    batch_size: int
    generator: torch.Generator

    @property
    def device(self) -> torch.device:
        return next(self.state.model.parameters()).device

    def batch(self) -> dict:
        cfg = self.cfg
        latent = cfg["image_size"] // 2 ** (len(cfg["model"]["vae_ch_mult"]) - 1)
        return synthetic_mv_batch(
            self.generator, self.batch_size,
            cfg["num_input_views"] + cfg["num_novel_views"],
            cfg["image_size"], cfg["num_input_views"], latent, self.device)

    def step(self, batch: dict | None = None) -> dict:
        return self.train_step(self.state,
                               self.batch() if batch is None else batch)


def build_gsdecoder_trainer(small: bool = False,
                            device: str | torch.device = "cuda",
                            seed: int = 0, batch_size: int | None = None
                            ) -> GSDecoderTrainer:
    """The stage-1 run at flagship (or ``small``) widths with seeded random
    weights on ``device``; bf16-mixed on a card, fp32 on the CPU."""
    device = resolve_device(device)
    cfg = SMALL_GSDECODER_TRAIN if small else GSDECODER_TRAIN
    with torch.device("meta"):
        model = GSDecoderModel(**cfg["model"])
    g = torch.Generator(device=device).manual_seed(seed)
    model.to_empty(device=device)
    init_random_(model, g)
    model.train()
    system = GSDecoderSystem(
        model, render_size=cfg["render_size"],
        compute_dtype=torch.bfloat16 if device.type == "cuda"
        else torch.float32)
    opt = make_optimizer(model.parameters(), cfg["learning_rate"],
                         cfg["weight_decay"], cfg["betas"])
    n_in = cfg["num_input_views"]

    def loss_fn(batch):
        return system.loss(batch, num_input_views=n_in,
                           render_size=cfg["render_size"])

    step = make_train_step(loss_fn, opt, ema_decay=cfg["ema_decay"],
                           grad_accum=cfg["accumulate_grad_batches"],
                           grad_clip=cfg["grad_clip"])
    return GSDecoderTrainer(system, init_train_state(model, opt), step, cfg,
                            batch_size or cfg["batch_size"], g)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--stage", default="gsdecoder",
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
    p.add_argument("--device", default="cuda")
    p.add_argument("--render_loss", action="store_true")
    p.add_argument("--ckpt_dir", default=None)
    return p.parse_args(argv)


def main(argv=None) -> GSDecoderTrainer:
    args = parse_args(argv)
    if args.stage != "gsdecoder":
        raise NotImplementedError(
            f"--stage {args.stage} is not ported yet (ROADMAP.md)")
    if not args.synthetic:
        raise NotImplementedError(
            "training data on disk is not ported yet: pass --synthetic")
    if args.render_loss:
        raise NotImplementedError("--render_loss is not ported yet")
    if args.ckpt_dir is not None:
        raise NotImplementedError("checkpoints are not ported yet")
    trainer = build_gsdecoder_trainer(small=args.small, device=args.device,
                                      seed=args.seed,
                                      batch_size=args.batch_size)
    max_steps = (args.max_steps if args.max_steps > 0
                 else trainer.cfg["steps_per_epoch"])
    t_start = time.time()
    for step in range(max_steps):
        metrics = trainer.step()
        if step % args.log_every == 0:
            line = {"step": step, "time": round(time.time() - t_start, 2),
                    **{k: float(v) for k, v in metrics.items()}}
            print(json.dumps(line), flush=True)
    return trainer


if __name__ == "__main__":
    main()
