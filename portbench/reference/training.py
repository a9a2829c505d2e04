"""Frozen copies (commit 078c4a5) of the stage-2 training step's parts, for
the reference that follows the program's first training steps:

- ``synthetic_mvldm_batch`` and ``dummy_sv_camera`` (``train.py``);
- ``draw_multi_view``, ``multi_view_loss`` and ``single_view_loss``
  (``systems/mv_ldm_system.py``, one process, no metrics);
- the step of ``parallel/train_step.py``: the gradients clipped by their
  global norm, ``AdamW`` with the bf16 first moment (optax's arithmetic),
  the EMA.

The losses take the whole batch's draws and a ``rows`` slice, so that the
reference can run the batch a few scenes at a time: each slice's loss is
its share of the whole batch's, and the gradients add up.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .cameras import get_random_cameras
from .rays import raymap as make_raymap
from .schedulers import make_schedule

VPRED = make_schedule("vprediction")


def synthetic_mvldm_batch(generator: torch.Generator, B: int, N: int,
                          img: int, ctx_dim: int, sv: int = 0,
                          device="cpu") -> dict:
    """A random stage-2 batch: orbit cameras shared by the batch, images
    uniform in [-1, 1], disparities uniform in [0.05, 1], text embeddings
    ``N(0, 0.02^2)`` and zero unconditional ones; with ``sv`` also ``sv``
    text-to-image images a scene and their shared ``text_emb_sv``."""
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
    s = image_size / 256.0
    return torch.tensor([1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 207.3 * s,
                         207.3 * s, 128.0 * s, 128.0 * s, float(image_size),
                         float(image_size)], dtype=torch.float32)


def draw_multi_view(generator, B: int, N: int, hw: int, *,
                    drop_pose_p: float, drop_text_p: float,
                    latent_channel: int = 4, device="cpu") -> dict:
    """The draws of one ``multi_view_loss``, in the program's order."""
    g = dict(generator=generator, device=device)
    c = latent_channel
    return {
        "sigmas": VPRED.sample_train_sigmas((B,), **g),
        "noise": torch.randn(B, N, 2 * c, hw, hw, **g),
        "ref_views": torch.randperm(N, **g)[:0],
        "keep_pose": torch.rand(B, **g) >= drop_pose_p,
        "keep_text": torch.rand(B, **g) >= drop_text_p,
        "encode_noise": torch.randn(B, 2 * N, c, hw, hw, **g),
    }


def sv_batch(batch: dict, dummy_camera: torch.Tensor) -> dict:
    """The text-to-image images as 1-view scenes, pose always dropped."""
    images = batch["images_sv"]
    B, M = images.shape[:2]
    emb = batch["text_emb_sv"].repeat_interleave(M, dim=0)
    return {
        "images_mv": images.reshape((B * M, 1) + images.shape[2:]),
        "depths_mv": batch["depths_sv"].reshape(
            (B * M, 1) + batch["depths_sv"].shape[2:]),
        "cameras_mv": dummy_camera.to(images.device).expand(B * M, 1, 18),
        "text_emb": emb,
        "uncond_text_emb": batch["uncond_text_emb"].repeat_interleave(
            M, dim=0),
    }


def multi_view_loss(model, batch: dict, draws: dict, rows: slice,
                    compute_dtype=torch.float32) -> torch.Tensor:
    """The latent denoising loss (image and depth latents, loss-weighted
    x0 MSE, no reference views) of the scenes ``rows``, as their share of
    the whole batch's loss. ``compute_dtype`` other than float32 runs the
    networks under autocast."""
    sub = {k: v[rows] for k, v in batch.items()}
    d = {k: (v if k == "ref_views" else v[rows]) for k, v in draws.items()}
    B_all = batch["images_mv"].shape[0]
    images, cameras, depths = (sub["images_mv"], sub["cameras_mv"],
                               sub["depths_mv"])
    B, N = images.shape[:2]
    dev = images.device
    auto = (contextlib.nullcontext if compute_dtype == torch.float32 else
            lambda: torch.autocast(device_type=dev.type, dtype=compute_dtype))
    depths_in = (depths * 2.0 - 1.0).expand(-1, -1, 3, -1, -1)
    with torch.no_grad(), auto():
        lat = model.encode_image(torch.cat([images, depths_in], 1),
                                 d["encode_noise"])
    x0 = torch.cat([lat[:, :N], lat[:, N:]], dim=2).float()
    h, w = x0.shape[-2:]
    sig = d["sigmas"].to(device=dev, dtype=torch.float32)[
        :, None, None, None, None]
    t_cond = VPRED.c_noise(sig[:, 0, 0, 0, 0])[:, None].expand(B, N)
    noisy = VPRED.add_noise(x0, d["noise"].to(x0), sig)
    net_in = VPRED.c_in(sig) * noisy
    cond = make_raymap(cameras.float(), h, w) * d["keep_pose"].to(dev)[
        :, None, None, None, None]
    cond = torch.cat([cond, torch.zeros_like(cond[:, :, :1])], dim=2)
    net_in = torch.cat([net_in, cond], dim=2)
    text_emb = torch.where(d["keep_text"].to(dev)[:, None, None],
                           sub["text_emb"], sub["uncond_text_emb"])
    with auto():
        pred = model.denoise(net_in, text_emb, t_cond)
    x0_pred = VPRED.denoise_output_to_x0(noisy, pred.float(), sig)
    wgt = VPRED.loss_weight(sig)
    denom = B_all * 4 * h * w
    err = wgt * (x0_pred - x0) ** 2
    return (err[:, :, 0:4].sum() + err[:, :, 4:8].sum()) / denom


class AdamW:
    """optax's ``adamw`` with a bf16 first moment, as the port's
    ``parallel/train_step.py::AdamW``: the new moment is formed in fp32
    from the stored bf16 one (``b1`` rounded to bf16), used, then
    stored in bf16; the second moment in fp32."""

    def __init__(self, params: dict, lr=1e-5, betas=(0.9, 0.95), eps=1e-8,
                 weight_decay=1e-4, mu_dtype=torch.bfloat16):
        self.params, self.lr, self.betas = params, lr, betas
        self.eps, self.wd, self.count = eps, weight_decay, 0
        self.mu = {n: torch.zeros_like(p, dtype=mu_dtype)
                   for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.count += 1
        b1, b2 = self.betas
        f32 = np.float32
        c1 = float(f32(1) - f32(b1) ** self.count)
        c2 = float(f32(1) - f32(b2) ** self.count)
        b1_mu = float(torch.tensor(b1, dtype=next(iter(
            self.mu.values())).dtype))
        for n, p in self.params.items():
            g = grads[n]
            m = g * (1.0 - b1) + self.mu[n].float() * b1_mu
            self.nu[n].mul_(b2).add_(g * g * (1.0 - b2))
            den = (self.nu[n] / c2).sqrt_().add_(self.eps)
            upd = m / c1 / den
            if self.wd:
                upd = upd + p * self.wd
            p.add_(upd * -self.lr)
            self.mu[n].copy_(m)


def clip_by_global_norm(grads: dict, limit: float) -> torch.Tensor:
    """Scales ``grads`` in place to the global norm ``limit`` where it is
    above; returns the norm before."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads.values()]))
    if float(norm) >= limit:
        for g in grads.values():
            g.div_(norm).mul_(limit)
    return norm
