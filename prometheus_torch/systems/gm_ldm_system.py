"""GM-LDM system: training loss and sampling of the legacy single-model
variant (``prometheus_tpu/systems/gm_ldm_system.py``).

The U-Net denoises RGB latents conditioned on raymaps; the gaussian-headed
VAE decoder turns the x0 latents directly into 3D Gaussians, which the
renderer draws. The loss's random draws (the encoder's posterior noise, one
sigma per scene, the denoising noise and the per-scene text dropout) come
from a ``torch.Generator`` or, for parity, from a ``draws`` dict the caller
fills (``draw``); the sampler starts from a given ``x`` or draws it. With
``compute_dtype`` bf16 the networks run under autocast; the
preconditioning, the loss and the sampler's state are float32.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .. import profiling
from ..models.gm_ldm import GMLDMModel
from ..ops.gaussian import convert_gaussians, render_gaussians
from ..ops.schedulers import Schedule, make_schedule
from ..utils.rays import raymap as make_raymap


@dataclasses.dataclass(eq=False)
class GMLDMSystem:
    model: GMLDMModel
    schedule: Schedule = dataclasses.field(
        default_factory=lambda: make_schedule("vprediction"))
    compute_dtype: torch.dtype = torch.float32

    def _autocast(self, device: torch.device):
        return torch.autocast(device_type=device.type, dtype=self.compute_dtype,
                              enabled=self.compute_dtype != torch.float32)

    def draw(self, generator: torch.Generator | None, B: int, N: int,
             hw: int, drop_text_p: float = 0.1,
             device: torch.device | str = "cpu") -> dict:
        """The random draws of one ``loss``, in JAX's order and
        distributions: standard-normal ``encode_noise (B, N, 4, hw, hw)``
        for the posterior sample, ``sigmas (B,)``, standard-normal ``noise
        (B, N, 4, hw, hw)`` and ``keep_text (B,)`` (a uniform draw at or
        above ``drop_text_p``)."""
        g = dict(generator=generator, device=device)
        c = self.model.latent_channel
        return {
            "encode_noise": torch.randn(B, N, c, hw, hw, **g),
            "sigmas": self.schedule.sample_train_sigmas((B,), **g),
            "noise": torch.randn(B, N, c, hw, hw, **g),
            "keep_text": torch.rand(B, **g) >= drop_text_p,
        }

    def loss(self, batch: dict, *, draws: dict | None = None,
             generator: torch.Generator | None = None,
             drop_text_p: float = 0.1):
        """The latent denoising MSE (RGB latents only) on ``images_mv (B, N,
        3, H, W)`` in [-1, 1], ``cameras_mv (B, N, 18)``, ``text_emb`` and
        ``uncond_text_emb (B, L, D)``: the frozen encoder's posterior
        sample, one sigma per scene, the raymap concatenated after
        ``c_in``, per-scene text dropout, and the ``loss_weight``-weighted
        MSE of the x0 prediction. Returns ``(loss, {"loss_gm_latent_mse":
        loss})``."""
        images, cameras = batch["images_mv"], batch["cameras_mv"]
        B, N = images.shape[:2]
        dev = images.device
        hw = images.shape[-1] // 2 ** (len(self.model.vae_ch_mult) - 1)
        if draws is None:
            draws = self.draw(generator, B, N, hw, drop_text_p, dev)
        with torch.no_grad(), self._autocast(dev):       # frozen encoder
            x0 = self.model.encode_image(images, draws["encode_noise"])
        h, w = x0.shape[-2:]
        sigmas = draws["sigmas"].to(device=dev, dtype=torch.float32)
        sig = sigmas[:, None, None, None, None]
        noisy = x0 + sig * draws["noise"].to(x0)
        rm = make_raymap(cameras.float(), h, w)
        net_in = torch.cat([self.schedule.c_in(sig) * noisy, rm], dim=2)
        t_cond = self.schedule.c_noise(sigmas)[:, None].expand(B, N)
        keep = draws["keep_text"].to(dev)[:, None, None]
        text_emb = torch.where(keep, batch["text_emb"],
                               batch["uncond_text_emb"])
        with self._autocast(dev):
            pred = self.model.denoise(net_in, text_emb, t_cond)
        x0_pred = self.schedule.denoise_output_to_x0(noisy, pred.float(), sig)
        loss = torch.mean(self.schedule.loss_weight(sig) * (x0_pred - x0) ** 2)
        return loss, {"loss_gm_latent_mse": loss.detach().clone()}

    @torch.no_grad()
    def sample(self, cameras: torch.Tensor, text_embeddings: torch.Tensor,
               uncond_text_embeddings: torch.Tensor, *,
               x: torch.Tensor | None = None,
               generator: torch.Generator | None = None,
               num_inference_steps: int = 50, guidance_scale: float = 7.5,
               latent_hw: int = 32, render_size: int = 256,
               mark: Callable | None = None) -> dict:
        """Text -> gaussians and renders through the single model: the
        Euler loop from ``x`` (``(B, N, 4, h, w)``, already scaled by the
        first sigma; ``sigma_0 * N(0, 1)`` from ``generator`` unless given)
        with plain CFG (cond and uncond stacked in one call, no rescale),
        the LAST x0 prediction decoded to gaussians and rendered at
        ``render_size``. ``mark(stage)`` is called after the ``denoise``
        loop, the VAE ``decode``, the ``convert`` and the ``render``.
        Returns ``latents_pred``, ``gaussians``, ``images_gs_render`` and
        ``depths_gs_render``."""
        mark = mark or (lambda stage: None)
        B, N = cameras.shape[:2]
        dev = cameras.device
        h = w = latent_hw
        rm = make_raymap(cameras.float(), h, w)
        sigmas = self.schedule.inference_sigmas(num_inference_steps).to(dev)
        if x is None:
            x = sigmas[0] * torch.randn((B, N, self.model.latent_channel, h, w),
                                        generator=generator, device=dev)
        x = x.to(device=dev, dtype=torch.float32)
        txt = torch.cat([text_embeddings, uncond_text_embeddings], 0)
        x0 = x
        for i in range(num_inference_steps):
            with profiling.span("sampler.step"):
                sigma, sigma_next = sigmas[i], sigmas[i + 1]
                x_in = torch.cat([self.schedule.c_in(sigma) * x, rm], dim=2)
                t = self.schedule.c_noise(sigma).expand(2 * B, N)
                with self._autocast(dev):
                    out = self.model.denoise(torch.cat([x_in, x_in], 0), txt,
                                             t)
                cond, uncond = out.float().chunk(2, dim=0)
                guided = uncond + guidance_scale * (cond - uncond)
                x0 = self.schedule.denoise_output_to_x0(x, guided, sigma)
                x = self.schedule.euler_step(x, x0, sigma, sigma_next)
        mark("denoise")
        with self._autocast(dev):
            raw = self.model.decode_raw(x0, rm)
        mark("decode")
        gaussians = convert_gaussians(raw, cameras, mode="director3d")
        mark("convert")
        imgs, deps, _ = render_gaussians(cameras, gaussians, h=render_size,
                                         w=render_size)
        mark("render")
        return {"latents_pred": x0, "gaussians": gaussians,
                "images_gs_render": imgs, "depths_gs_render": deps}
