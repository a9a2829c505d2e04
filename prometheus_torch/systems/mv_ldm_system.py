"""MV-LDM sampling (``prometheus_tpu/systems/mv_ldm_system.py``).

The denoising loop over the schedule's sigma ladder, with classifier-free
guidance as batch stacking:

- ``text``   : [cond, uncond-text], the same pose;
- ``pose``   : [cond, uncond-pose], the same text;
- ``joint``  : [cond, uncond-both] (the flagship);
- ``hybrid`` : [cond, uncond-both, pose-only], text scale 2g/3 and pose
  scale g/3;
- ``none``   : the conditional row alone.

Guidance and the std-matching CFG rescale act on the raw network output.
Latents per view are ``[rgb latent 4, depth latent 4]`` plus the
conditioning ``[raymap 6, view mask 1]``. The steps are Euler (the
reference's) or DPM-Solver++(2M) over a Karras ladder; ``cfg_interval_frac``
guides only the first, high-noise fraction of the steps. 3D mode
(``sample_with_3d_mode``) replaces every m-th step's prediction by the
re-encoded render of the gaussians it decodes to.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..models.mv_ldm import MVLDMModel
from ..models.unet_mv import precompute_text_kv
from ..ops.gaussian import render_gaussians
from ..ops.schedulers import Schedule, make_schedule
from ..utils.rays import raymap as make_raymap

# each guidance type's CFG stack: the (text, pose) of each row, c for the
# conditional and u for the unconditional embedding
GUIDANCE_ROWS = {"none": ("c", "c"), "text": ("cu", "cc"),
                 "pose": ("cc", "cu"), "joint": ("cu", "cu"),
                 "hybrid": ("cuc", "cuu")}
SAMPLERS = ("euler", "dpmpp_2m")


@dataclasses.dataclass(eq=False)
class MVLDMSystem:
    """Sampler around ``MVLDMModel``.

    ``adjust_sigma_on_n`` divides the ladder by ``sqrt(num_pred_views /
    N)``; ``timestep_type`` is ``continuous`` (``t = 0.25 log(sigma)``, the
    flagship) or ``discrete`` (the training timestep whose sigma is the
    first at or above it).
    """

    model: MVLDMModel
    schedule: Schedule = dataclasses.field(
        default_factory=lambda: make_schedule("vprediction"))
    latent_channel: int = 4
    num_pred_views: int = 8
    adjust_sigma_on_n: bool = False
    timestep_type: str = "continuous"

    def _pose_embeddings(self, cameras: torch.Tensor, h: int, w: int,
                         view_mask: torch.Tensor | None = None):
        """``(B, N, 18)`` -> cond / uncond pose maps ``(B, N, 7, h, w)``:
        the raymap plus the view mask (zero unless given); the uncond map is
        all zeros."""
        rm = make_raymap(cameras, h, w)
        mask = (torch.zeros_like(rm[:, :, :1]) if view_mask is None
                else view_mask.to(rm))
        rm = torch.cat([rm, mask], dim=2)
        return rm, torch.zeros_like(rm)

    def _t_cond(self, sigma: torch.Tensor) -> torch.Tensor:
        """The network's noise conditioning for ``sigma`` (any shape)."""
        table = self.schedule.train_sigmas
        if self.timestep_type == "discrete" and table is not None:
            table = torch.from_numpy(table).to(sigma.device)
            s = sigma.to(torch.float32)
            return torch.searchsorted(table, s.reshape(-1)).reshape(
                s.shape).to(torch.float32)
        return self.schedule.c_noise(sigma)

    def _guided_output(self, x, sigma, text_emb, uncond_text_emb, pose_emb,
                       uncond_pose_emb, guidance_type: str,
                       guidance_scale: float, cfg_rescale: float,
                       text_kv: dict | None = None) -> torch.Tensor:
        """``x (B, N, 8, h, w)`` VE-noisy latents -> the guided network
        output, float32."""
        B, N = x.shape[:2]
        x_in = x * self.schedule.c_in(sigma)
        t = self._t_cond(sigma).expand(B, N)
        t_rows, p_rows = GUIDANCE_ROWS[guidance_type]
        txts = [text_emb if c == "c" else uncond_text_emb for c in t_rows]
        poses = [pose_emb if c == "c" else uncond_pose_emb for c in p_rows]
        r = len(txts)
        inp = torch.cat([torch.cat([x_in] * r, dim=0),
                         torch.cat(poses, dim=0).to(x_in.dtype)], dim=2)
        out = self.model.denoise(inp, torch.cat(txts, dim=0),
                                 torch.cat([t] * r, dim=0),
                                 text_kv=text_kv).float()
        if guidance_type == "none":
            return out
        if guidance_type == "hybrid":
            cond, tuncond, puncond = out.chunk(3, dim=0)
            guided = (tuncond + (puncond - tuncond) * (2.0 * guidance_scale
                                                       / 3.0)
                      + (cond - puncond) * (guidance_scale / 3.0))
        else:
            cond, uncond = out.chunk(2, dim=0)
            guided = uncond + guidance_scale * (cond - uncond)
        if cfg_rescale > 0:
            dims = (1, 2, 3, 4)
            std_cond = torch.std(cond, dim=dims, keepdim=True, correction=0)
            std_g = torch.std(guided, dim=dims, keepdim=True, correction=0)
            factor = cfg_rescale * (std_cond / torch.clamp_min(std_g, 1e-8)) \
                + (1.0 - cfg_rescale)
            guided = guided * factor
        return guided

    def _text_kv_for_guidance(self, text_emb, uncond_text_emb,
                              guidance_type: str, N: int) -> dict:
        """Per-site text K/V for the guidance type's stacked, per-view
        repeated context rows, computed once per sample instead of at every
        step."""
        txt_all = torch.cat([text_emb if c == "c" else uncond_text_emb
                             for c in GUIDANCE_ROWS[guidance_type][0]])
        R, L, D = txt_all.shape
        ctx = txt_all[:, None].expand(R, N, L, D).reshape(R * N, L, D)
        return precompute_text_kv(self.model.unet, ctx)

    def _ladder(self, num_steps: int, N: int, sampler: str,
                device) -> torch.Tensor:
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}")
        sigmas = self.schedule.inference_sigmas(
            num_steps, ladder="karras" if sampler == "dpmpp_2m"
            else "default")
        if self.adjust_sigma_on_n:
            sigmas = sigmas / math.sqrt(self.num_pred_views / N)
        return sigmas.to(device)

    def _start(self, sigma0, shape, generator, noise, device):
        """``sigma_0 * noise``, float32; ``noise`` is drawn from
        ``generator`` unless given."""
        if noise is None:
            noise = torch.randn(shape, generator=generator, device=device)
        return sigma0 * noise.to(device=device, dtype=torch.float32)

    @torch.no_grad()
    def sample(self, cameras: torch.Tensor, text_embeddings: torch.Tensor,
               uncond_text_embeddings: torch.Tensor,
               generator: torch.Generator | None = None,
               num_inference_steps: int = 50, guidance_scale: float = 7.5,
               guidance_type: str = "joint", cfg_rescale: float = 0.7,
               latent_hw: int = 32, noise: torch.Tensor | None = None,
               view_mask: torch.Tensor | None = None,
               ref_latents: torch.Tensor | None = None,
               cfg_interval_frac: float | None = None,
               sampler: str = "euler") -> torch.Tensor:
        """Full denoising loop from ``sigma_0 * noise``; ``noise`` (standard
        normal, ``(B, N, 8, h, w)``) is drawn from ``generator`` unless given.
        ``view_mask (B, N, 1, h, w)`` with ``ref_latents (B, N, 8, h, w)``
        pins the masked views' x0 to their reference latents. Returns x0
        latents ``(B, N, 8, h, w)``."""
        B, N = cameras.shape[:2]
        sigmas = self._ladder(num_inference_steps, N, sampler, cameras.device)
        x = self._start(sigmas[0], (B, N, 2 * self.latent_channel, latent_hw,
                                    latent_hw), generator, noise,
                        cameras.device)
        return self._sample_core(
            x, sigmas, cameras, text_embeddings, uncond_text_embeddings,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, guidance_type=guidance_type,
            cfg_rescale=cfg_rescale, view_mask=view_mask,
            ref_latents=ref_latents, cfg_interval_frac=cfg_interval_frac,
            sampler=sampler)

    @torch.no_grad()
    def _sample_core(self, x, sigmas, cameras, text_embeddings,
                     uncond_text_embeddings, *, num_inference_steps: int,
                     guidance_scale: float, guidance_type: str,
                     cfg_rescale: float, view_mask=None, ref_latents=None,
                     cfg_interval_frac: float | None = None,
                     sampler: str = "euler") -> torch.Tensor:
        """The denoising loop from a given starting ``x`` (float32).

        With ``cfg_interval_frac`` the first ``round(frac * steps)`` steps
        (at least 1; Python's ``round``, half to even) are guided and the
        rest run the conditional row alone; the multistep state carries
        across."""
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}")
        if guidance_type not in GUIDANCE_ROWS:
            raise ValueError(f"unsupported guidance type {guidance_type}")
        N = cameras.shape[1]
        h, w = x.shape[-2:]
        pose_emb, uncond_pose_emb = self._pose_embeddings(cameras, h, w,
                                                          view_mask)
        n_cfg = num_inference_steps
        if cfg_interval_frac is not None and guidance_type != "none":
            n_cfg = min(num_inference_steps,
                        max(1, round(cfg_interval_frac * num_inference_steps)))
        kv = {guidance_type: self._text_kv_for_guidance(
            text_embeddings, uncond_text_embeddings, guidance_type, N)}
        if n_cfg < num_inference_steps:
            kv["none"] = self._text_kv_for_guidance(
                text_embeddings, uncond_text_embeddings, "none", N)
        x0 = x
        x0_prev, sigma_prev, has_prev = torch.zeros_like(x), sigmas[0], False
        for i in range(num_inference_steps):
            gtype = guidance_type if i < n_cfg else "none"
            sigma, sigma_next = sigmas[i], sigmas[i + 1]
            out = self._guided_output(
                x, sigma, text_embeddings, uncond_text_embeddings, pose_emb,
                uncond_pose_emb, gtype, guidance_scale, cfg_rescale,
                text_kv=kv[gtype])
            x0 = self.schedule.denoise_output_to_x0(x, out, sigma)
            if ref_latents is not None and view_mask is not None:
                x0 = torch.where(view_mask[:, :, :1] > 0.5,
                                 ref_latents.to(x0), x0)
            if sampler == "dpmpp_2m":
                x = self.schedule.dpmpp_2m_step(x, x0, x0_prev, sigma_prev,
                                                sigma, sigma_next, has_prev)
            else:
                x = self.schedule.euler_step(x, x0, sigma, sigma_next)
            x0_prev, sigma_prev, has_prev = x0, sigma, True
        return x0

    def render_to_latent(self, images: torch.Tensor,
                         depths: torch.Tensor) -> torch.Tensor:
        """Renders -> RGB-D latents ``(B, N, 8, h, w)``: ``images (B, N, 3,
        H, W)`` in [-1, 1] and metric ``depths (B, N, 1, H, W)``, turned
        into disparity normalised per view, encoded in one call over the
        ``2N`` images."""
        disp = 1.0 / torch.clamp(depths, 0.1, 100.0)
        lo = disp.amin(dim=(2, 3, 4), keepdim=True)
        hi = disp.amax(dim=(2, 3, 4), keepdim=True)
        disp = (disp - lo) / torch.clamp_min(hi - lo, 1e-6)
        depth3 = (disp * 2.0 - 1.0).expand(-1, -1, 3, -1, -1)
        N = images.shape[1]
        lat = self.model.encode_image(torch.cat([images, depth3], dim=1))
        return torch.cat([lat[:, :N], lat[:, N:]], dim=2)

    @torch.no_grad()
    def sample_with_3d_mode(
            self, decode_gaussians: Callable, cameras: torch.Tensor,
            text_embeddings: torch.Tensor,
            uncond_text_embeddings: torch.Tensor,
            generator: torch.Generator | None = None,
            num_inference_steps: int = 50, use_3d_mode_every_m_steps: int = 10,
            guidance_scale: float = 7.5, guidance_type: str = "joint",
            cfg_rescale: float = 0.7, latent_hw: int = 32,
            render_size: int = 256,
            noise: torch.Tensor | None = None) -> torch.Tensor:
        """The Euler loop with a render-consistent step wherever ``(steps -
        1 - i) % m == 0``: the unguided x0 is decoded to gaussians
        (``decode_gaussians(latents, cameras)``), rendered at
        ``render_size`` and re-encoded (``render_to_latent``). The other
        steps are guided at ``guidance_scale * m / (m - 1)``, which makes up
        for the unguided ones. ``m <= 0`` runs no 3D step; ``m == 1`` is
        refused."""
        m = use_3d_mode_every_m_steps
        if m == 1:
            raise ValueError("use_3d_mode_every_m_steps must not be 1")
        if m > 0:
            guidance_scale = guidance_scale * m / (m - 1)
        B, N = cameras.shape[:2]
        h = w = latent_hw
        sigmas = self._ladder(num_inference_steps, N, "euler", cameras.device)
        x = self._start(sigmas[0], (B, N, 2 * self.latent_channel, h, w),
                        generator, noise, cameras.device)
        pose_emb, uncond_pose_emb = self._pose_embeddings(cameras, h, w)
        kv_g = self._text_kv_for_guidance(
            text_embeddings, uncond_text_embeddings, guidance_type, N)
        kv_u = self._text_kv_for_guidance(
            text_embeddings, uncond_text_embeddings, "none", N)
        x0 = x
        for i in range(num_inference_steps):
            sigma, sigma_next = sigmas[i], sigmas[i + 1]
            use_3d = m > 0 and (num_inference_steps - 1 - i) % m == 0
            if use_3d:
                out = self._guided_output(
                    x, sigma, text_embeddings, uncond_text_embeddings,
                    pose_emb, uncond_pose_emb, "none", 1.0, 0.0, text_kv=kv_u)
                x0 = self.schedule.denoise_output_to_x0(x, out, sigma)
                gaussians = decode_gaussians(x0, cameras)
                imgs, deps, _ = render_gaussians(cameras, gaussians,
                                                 h=render_size, w=render_size)
                x0 = self.render_to_latent(imgs, deps)
            else:
                out = self._guided_output(
                    x, sigma, text_embeddings, uncond_text_embeddings,
                    pose_emb, uncond_pose_emb, guidance_type, guidance_scale,
                    cfg_rescale, text_kv=kv_g)
                x0 = self.schedule.denoise_output_to_x0(x, out, sigma)
            x = self.schedule.euler_step(x, x0, sigma, sigma_next)
        return x0

    @torch.no_grad()
    def decode_images_and_depths(self, latents: torch.Tensor):
        """x0 latents ``(B, N, 8, h, w)`` -> ``(images (B, N, 3, H, W) in
        [-1, 1], depths (B, N, 1, H, W) in [0, 1])``, one batched VAE decode
        of the RGB and depth latents."""
        N = latents.shape[1]
        both = torch.cat([latents[:, :, 0:4], latents[:, :, 4:8]], dim=1)
        dec = self.model.decode_latent(both).float()
        imgs, deps = dec[:, :N], dec[:, N:]
        return imgs, deps.mean(dim=2, keepdim=True) / 2.0 + 0.5

    @torch.no_grad()
    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.model.encode_text(input_ids)
