"""SDS++ test-time refiners of a 3DGS scene
(``prometheus_tpu/refiners/sds_pp.py``).

``GSRefinerSDSPlusPlus`` guides with a single-view latent diffusion model
and a learnable negative embedding (LoDS); ``MultiviewSDSPPRefiner`` guides
with the MV-LDM itself, the sampled views denoised jointly in the RGB-D
latent space. An iteration renders ``num_views`` cameras sampled along the
dense trajectory (kernel B), encodes the renders, computes the guidance
targets from the encoded renders held constant, pulls the renders and their
latents towards the targets through the encoder and the renderer (kernel
C), and takes one Adam step on the raw gaussian buffer and the embedding.
Every ``densification_interval`` iterations the buffer densifies and prunes
(``gs_manager``) and the Adam moments restart. The densification statistic
is the accumulated norm of each slot's position gradient.

The JAX package renders and encodes twice an iteration (once for the
targets, once under the gradient); here one render and one encoding under
autograd serve both, the targets reading them detached: the same
arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..ops.gaussian import render_gaussians
from ..ops.schedulers import make_ddim
from ..utils.cameras import sample_from_dense_cameras
from .gs_manager import (GaussianBuffer, activate, densify_and_prune,
                         make_buffer)

DEFAULT_LRS = {
    "xyz": 1e-4, "feats_raw": 1e-2, "opacity_raw": 5e-2,
    "scales_raw": 5e-3, "rots_raw": 1e-3, "embedding": 1e-3,
}
PARAMS = ("xyz", "feats_raw", "opacity_raw", "scales_raw", "rots_raw")


class Adam:
    """``optax.adam`` with its defaults (bias-corrected) and one learning
    rate per named tensor."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lrs: dict, params: dict):
        self.lrs = lrs
        self.reset(params)

    def reset(self, params: dict) -> None:
        """Zero moments and step count (optax's ``init``)."""
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        """The updated parameters (new tensors)."""
        self.count += 1
        # the bias corrections in float32, as optax computes them
        f32 = np.float32
        c1 = float(f32(1) - f32(self.b1) ** self.count)
        c2 = float(f32(1) - f32(self.b2) ** self.count)
        out = {}
        for k, g in grads.items():
            self.m[k] = (1 - self.b1) * g + self.b1 * self.m[k]
            self.v[k] = (1 - self.b2) * g * g + self.b2 * self.v[k]
            upd = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps)
            out[k] = params[k] - self.lrs[k] * upd
        return out


def _draw(draws, i: int, name: str):
    """The caller's draw ``name`` of iteration ``i``, or None."""
    if draws is None or i >= len(draws):
        return None
    return draws[i].get(name)


@dataclasses.dataclass(eq=False)
class GSRefinerSDSPlusPlus:
    """Single-view SDS++ with LoDS.

    ``denoise_fn(latents (B, 4, h, w), t (B,) int, text_emb (B, L, D)) ->
    eps`` wraps the guidance model; ``encode_fn (V, 3, H, W) -> (V, 4, h,
    w)`` and ``decode_fn`` its (frozen) VAE.
    """

    denoise_fn: Callable | None
    encode_fn: Callable
    decode_fn: Callable
    guidance_scale: float = 7.5
    num_views: int = 4
    img_size: int = 256
    total_iterations: int = 300
    densification_interval: int = 100
    capacity_factor: float = 1.5
    min_step_ratio: float = 0.02
    max_step_ratio: float = 0.75
    use_lods: bool = True
    lambda_latent_sds: float = 1.0
    lambda_image_sds: float = 0.1
    lambda_scale_reg: float = 10.0
    opacity_threshold: float = 0.01
    lrs: dict = dataclasses.field(default_factory=lambda: dict(DEFAULT_LRS))

    def __post_init__(self):
        self.schedule = make_ddim(kind="scaled_linear")
        n = self.schedule.num_train_timesteps
        self.min_step = int(n * self.min_step_ratio)
        self.max_step = int(n * self.max_step_ratio)

    def _t_for_iter(self, i: int) -> int:
        """The timestep of iteration ``i``, annealed by ``sqrt(i / T)``
        from ``max_step`` down to ``min_step``: float32 arithmetic, then
        truncation, as the JAX package computes it."""
        f32 = np.float32
        frac = np.sqrt(f32(i) / f32(self.total_iterations))
        return int(frac * f32(self.min_step - self.max_step)
                   + f32(self.max_step))

    def _encode(self, images: torch.Tensor, depths: torch.Tensor):
        """Renders -> the latents the guidance and the pull loss read."""
        return self.encode_fn(images)

    def _guidance_targets(self, latents, images, cams, t: int, text_emb,
                          uncond_emb, learn_emb, noise):
        """The targets from the encoded renders ``latents`` (constants):
        ``(targets, loss_embedding, grad_embedding)``. With LoDS the
        embedding's loss is differentiated through the guidance model."""
        B = latents.shape[0]
        dev = latents.device
        tb = torch.full((B,), t, dtype=torch.int64, device=dev)
        ab = self.schedule.alphas_cumprod.to(dev)[tb][:, None, None, None]
        noisy = torch.sqrt(ab) * latents + torch.sqrt(1 - ab) * noise
        bcast = lambda e: e.expand((B,) + e.shape[1:])
        if self.use_lods:
            emb = learn_emb.detach().requires_grad_()
            with torch.enable_grad():
                eps_learn = self.denoise_fn(noisy, tb, bcast(emb)).float()
                loss_emb = torch.mean((eps_learn - noise) ** 2)
                (grad_emb,) = torch.autograd.grad(loss_emb, emb)
            eps_learn, loss_emb = eps_learn.detach(), loss_emb.detach()
        else:
            eps_learn = noise
            loss_emb = noise.new_zeros(())
            grad_emb = torch.zeros_like(learn_emb)
        with torch.no_grad():
            eps = self.denoise_fn(
                torch.cat([noisy, noisy]), torch.cat([tb, tb]),
                torch.cat([bcast(text_emb), bcast(uncond_emb)])).float()
            eps_cond, eps_uncond = eps.chunk(2)
            eps_g = eps_uncond + self.guidance_scale * (eps_cond - eps_uncond)
            alpha, sigma = torch.sqrt(ab), torch.sqrt(1 - ab)
            latents_pred = (noisy - sigma * (eps_g - eps_learn + noise)) \
                / alpha
            images_pred = torch.clamp(self.decode_fn(latents_pred), -1, 1)
        targets = {"latents_pred": latents_pred, "images_pred": images_pred,
                   "scale": ((1 - ab) * alpha / sigma)[:, 0, 0, 0]}
        return targets, loss_emb, grad_emb

    def _pull_loss(self, latents, images, targets):
        """The loss pulling the renders and their latents to the targets."""
        B = latents.shape[0]
        scale = targets["scale"]
        loss_latent = torch.sum(torch.sum(
            (latents - targets["latents_pred"]) ** 2, dim=(1, 2, 3))
            * scale) / B
        loss_image = torch.sum(torch.sum(
            (images - targets["images_pred"]) ** 2, dim=(1, 2, 3))
            * scale) / B
        return (self.lambda_latent_sds * loss_latent
                + self.lambda_image_sds * loss_image)

    def refine_gaussians(self, gaussians, text_emb: torch.Tensor,
                         uncond_emb: torch.Tensor,
                         dense_cameras: torch.Tensor,
                         generator: torch.Generator | None = None,
                         draws: Sequence[dict] | None = None,
                         log: list | None = None):
        """Refine a gaussian tuple; returns the refined, activated tuple
        ``(1, C, ...)`` (dead slots at zero opacity).

        ``text_emb`` and ``uncond_emb`` are ``(1, L, D)``. Each iteration
        draws the camera times ``ts (1, num_views)`` (uniform), the latent
        noise and, at a densify round, the densify noise ``(min(4096, C),
        3)`` from ``generator``, unless ``draws[i]`` gives them under
        ``"ts"``, ``"noise"`` and ``"densify_noise"``. ``log`` receives one
        dict an iteration: its ``loss`` (the pull loss, the regulariser and
        the embedding's loss), ``t``, the updated ``learn_emb``, and at a
        densify round the alive counts ``alive_before`` and ``alive_after``
        (0-d tensors).
        """
        n0 = gaussians[0].shape[1]
        capacity = int(n0 * self.capacity_factor)
        buf = make_buffer(gaussians, capacity)
        dev = buf.xyz.device
        dense = dense_cameras[:1].to(device=dev, dtype=torch.float32)
        learn_emb = torch.zeros_like(uncond_emb, dtype=torch.float32)
        params = dict(zip(PARAMS, buf[:5]), embedding=learn_emb)
        opt = Adam(self.lrs, params)
        grad_stat = torch.zeros(capacity, device=dev)
        S = self.img_size
        for i in range(self.total_iterations):
            entry = {}
            if i > 0 and i % self.densification_interval == 0:
                entry["alive_before"] = buf.alive.sum()
                buf = densify_and_prune(
                    buf, grad_stat / self.densification_interval,
                    noise=_draw(draws, i, "densify_noise"),
                    generator=generator, opacity_prune=self.opacity_threshold)
                entry["alive_after"] = buf.alive.sum()
                grad_stat = torch.zeros_like(grad_stat)
                params = dict(zip(PARAMS, buf[:5]), embedding=learn_emb)
                opt.reset(params)
            ts = _draw(draws, i, "ts")
            if ts is None:
                ts = torch.rand((1, self.num_views), generator=generator,
                                device=dev)
            cams = sample_from_dense_cameras(dense, ts.to(dev))
            t = self._t_for_iter(i)
            leaves = [p.detach().requires_grad_() for p in buf[:5]]
            with torch.enable_grad():
                b = GaussianBuffer(*leaves, alive=buf.alive)
                imgs, deps, _ = render_gaussians(cams, activate(b), h=S, w=S)
                images = imgs.reshape(-1, 3, S, S)
                latents = self._encode(images, deps)
            noise = _draw(draws, i, "noise")
            if noise is None:
                noise = torch.randn(latents.shape, generator=generator,
                                    device=dev)
            targets, loss_emb, grad_emb = self._guidance_targets(
                latents.detach(), images.detach(), cams, t, text_emb,
                uncond_emb, learn_emb, noise.to(device=dev,
                                                dtype=torch.float32))
            with torch.enable_grad():
                loss = self._pull_loss(latents, images, targets)
                scal = torch.exp(b.scales_raw).amax(-1)
                loss = loss + self.lambda_scale_reg * torch.sum(torch.where(
                    b.alive & (scal > 0.1), scal, torch.zeros_like(scal)))
                grads = torch.autograd.grad(loss, leaves)
            new = opt.step(dict(zip(PARAMS, buf[:5]), embedding=learn_emb),
                           dict(zip(PARAMS, grads), embedding=grad_emb))
            buf = GaussianBuffer(*(new[k] for k in PARAMS), alive=buf.alive)
            learn_emb = new["embedding"]
            grad_stat = grad_stat + torch.linalg.norm(grads[0], dim=-1)
            if log is not None:
                entry.update(loss=loss.detach() + loss_emb, t=t,
                             learn_emb=learn_emb)
                log.append(entry)
        return tuple(g.detach() for g in activate(buf))


@dataclasses.dataclass(eq=False)
class MultiviewSDSPPRefiner(GSRefinerSDSPlusPlus):
    """MV-SDS++: the sampled views are denoised jointly by the MV-LDM
    (``mvldm_system``, an ``MVLDMSystem``; raymap-conditioned cross-view
    attention) in the 8-channel RGB-D latent space, with joint CFG and no
    rescale; the pull is ``||latents - x0||^2 / (sigma^2 + 1)``. The noise
    level is ``train_sigmas[t]`` (``exp(p_mean + p_std)`` for EDM). No
    LoDS."""

    mvldm_system: Any = None
    use_lods: bool = False

    def _encode(self, images, depths):
        """Renders -> joint ``(1, V, 8, h, w)`` RGB-D latents; the rendered
        depth is clipped to [0, 1] (as the reference does with this metric
        depth) and encoded with the images in one call."""
        V, S = self.num_views, self.img_size
        depth3 = (torch.clamp(depths, 0.0, 1.0).reshape(V, 1, S, S) * 2
                  - 1).expand(-1, 3, -1, -1)
        lat = self.encode_fn(torch.cat([images, depth3]))
        hw = lat.shape[-1]
        return torch.cat([lat[:V], lat[V:]], dim=1).reshape(1, V, 8, hw, hw)

    @torch.no_grad()
    def _guidance_targets(self, latents, images, cams, t: int, text_emb,
                          uncond_emb, learn_emb, noise):
        sys_ = self.mvldm_system
        sch = sys_.schedule
        hw = latents.shape[-1]
        if sch.train_sigmas is not None:
            sigma = torch.tensor(float(sch.train_sigmas[t]))
        else:
            sigma = torch.exp(torch.tensor(sch.p_mean + sch.p_std))
        sigma = sigma.to(latents.device)
        noisy = latents + sigma * noise
        pose_emb, uncond_pose = sys_._pose_embeddings(cams, hw, hw)
        out = sys_._guided_output(noisy, sigma, text_emb, uncond_emb,
                                  pose_emb, uncond_pose, "joint",
                                  self.guidance_scale, 0.0)
        x0 = sch.denoise_output_to_x0(noisy, out, sigma)
        targets = {"x0": x0, "w": 1.0 / (sigma**2 + 1.0)}
        return targets, noise.new_zeros(()), torch.zeros_like(learn_emb)

    def _pull_loss(self, latents, images, targets):
        loss_latent = torch.sum(
            targets["w"] * (latents - targets["x0"]) ** 2) / self.num_views
        return self.lambda_latent_sds * loss_latent
