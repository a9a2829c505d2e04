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

Training (``multi_view_loss``, ``single_view_loss``, ``rendering_loss``) is
the JAX system's. Its random draws (one sigma per scene, the denoising and
encoding noise, the reference views, the per-scene pose and text dropout)
come from a ``torch.Generator`` or, for parity, from a ``draws`` dict the
caller fills. With ``compute_dtype`` bf16 the networks run under autocast
(bf16 compute, fp32 parameters); the preconditioning, losses and metrics
run in fp32. The frozen VAE encodes under ``torch.no_grad``.

View sharding over a process group (``prometheus_tpu``'s ``view_axis``):
``sample_view_sharded`` runs each rank's share of the N views through the
sampler, the U-Net's joint sites gathering K and V over the group and the
CFG-rescale std reduced over every view of the scene; the result is
``sample``'s. ``multi_view_loss_view_sharded`` is the sequence-parallel
training loss: scene-level draws from a generator seeded alike on every
rank, per-view draws from one seeded per rank, reductions over the group.
It returns this rank's term of the loss over the global denominators: the
ranks' terms sum to the loss, and their gradients summed over the ranks
are its gradient (an all-reduced loss would multiply them by the world
size).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from .. import profiling
from ..models.mv_ldm import MVLDMModel
from ..models.unet_mv import precompute_text_kv
from ..ops.gaussian import convert_gaussians, render_gaussians
from ..ops.schedulers import Schedule, make_schedule
from ..parallel.dist import (all_gather_cat, all_reduce_, get_rank,
                             resolve_group, shard_batch_views, world_size)
from ..utils.rays import raymap as make_raymap
from .depth_loss import scale_and_shift_invariant_loss
from .gs_decoder_system import psnr

# each guidance type's CFG stack: the (text, pose) of each row, c for the
# conditional and u for the unconditional embedding
GUIDANCE_ROWS = {"none": ("c", "c"), "text": ("cu", "cc"),
                 "pose": ("cc", "cu"), "joint": ("cu", "cu"),
                 "hybrid": ("cuc", "cuu")}
SAMPLERS = ("euler", "dpmpp_2m")


@dataclasses.dataclass(eq=False)
class MVLDMSystem:
    """Sampler around ``MVLDMModel``.

    ``adjust_sigma_on_n`` divides the ladder (and the training sigmas) by
    ``sqrt(num_pred_views / N)``; ``timestep_type`` is ``continuous`` (``t
    = 0.25 log(sigma)``, the flagship) or ``discrete`` (the training
    timestep whose sigma is the first at or above it). ``noise_type``
    ``view_cond`` adds the view-mask channel to the conditioning,
    ``vanilla`` does not. The training loss logs per-scene sums and counts
    in the ``log10(sigma)`` buckets of ``sigma_bucket_edges``.
    """

    model: MVLDMModel
    schedule: Schedule = dataclasses.field(
        default_factory=lambda: make_schedule("vprediction"))
    latent_channel: int = 4
    num_pred_views: int = 8
    adjust_sigma_on_n: bool = False
    timestep_type: str = "continuous"
    noise_type: str = "view_cond"
    sigma_bucket_edges: tuple = (-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0)
    compute_dtype: torch.dtype = torch.float32

    def _autocast(self, device: torch.device):
        return torch.autocast(device_type=device.type, dtype=self.compute_dtype,
                              enabled=self.compute_dtype != torch.float32)

    def _pose_embeddings(self, cameras: torch.Tensor, h: int, w: int,
                         view_mask: torch.Tensor | None = None):
        """``(B, N, 18)`` -> cond / uncond pose maps ``(B, N, 7, h, w)``:
        the raymap plus, for ``view_cond``, the view mask (zero unless
        given); the uncond map is all zeros."""
        rm = make_raymap(cameras, h, w)
        if self.noise_type == "view_cond":
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
                       text_kv: dict | None = None,
                       view_group=None) -> torch.Tensor:
        """``x (B, N, 8, h, w)`` VE-noisy latents -> the guided network
        output, float32. With ``view_group`` the N views are this rank's
        share and the rescale's std spans every view of the scene."""
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
                                 text_kv=text_kv,
                                 view_group=view_group).float()
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
            std_cond = scene_std(cond, view_group)
            std_g = scene_std(guided, view_group)
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
                     sampler: str = "euler",
                     view_group=None) -> torch.Tensor:
        """The denoising loop from a given starting ``x`` (float32); with
        ``view_group`` over this rank's share of the views.

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
            with profiling.span("sampler.step"):
                gtype = guidance_type if i < n_cfg else "none"
                sigma, sigma_next = sigmas[i], sigmas[i + 1]
                out = self._guided_output(
                    x, sigma, text_embeddings, uncond_text_embeddings,
                    pose_emb, uncond_pose_emb, gtype, guidance_scale,
                    cfg_rescale, text_kv=kv[gtype], view_group=view_group)
                x0 = self.schedule.denoise_output_to_x0(x, out, sigma)
                if ref_latents is not None and view_mask is not None:
                    x0 = torch.where(view_mask[:, :, :1] > 0.5,
                                     ref_latents.to(x0), x0)
                if sampler == "dpmpp_2m":
                    x = self.schedule.dpmpp_2m_step(
                        x, x0, x0_prev, sigma_prev, sigma, sigma_next,
                        has_prev)
                else:
                    x = self.schedule.euler_step(x, x0, sigma, sigma_next)
                x0_prev, sigma_prev, has_prev = x0, sigma, True
        return x0

    @torch.no_grad()
    def sample_view_sharded(
            self, group, cameras: torch.Tensor,
            text_embeddings: torch.Tensor,
            uncond_text_embeddings: torch.Tensor,
            generator: torch.Generator | None = None,
            num_inference_steps: int = 50, guidance_scale: float = 7.5,
            guidance_type: str = "joint", cfg_rescale: float = 0.7,
            latent_hw: int = 32, noise: torch.Tensor | None = None,
            view_mask: torch.Tensor | None = None,
            ref_latents: torch.Tensor | None = None,
            cfg_interval_frac: float | None = None,
            sampler: str = "euler") -> torch.Tensor:
        """``sample`` with the N views of ``cameras (B, N, 18)`` split over
        the ranks of ``group`` in rank order: each rank runs the loop on its
        ``N / world`` views, the joint sites gathering K and V of every
        view. The starting noise is ``sample``'s, drawn whole (or given
        whole) and sliced; the ladder uses the global N. Every rank passes
        the same inputs and gets the whole ``(B, N, 8, h, w)`` x0 latents
        back (gathered). Raises ``ValueError`` unless the world size divides
        N. ``group`` None is the world's group."""
        group = resolve_group(group)
        B, N = cameras.shape[:2]
        W, r = world_size(group), get_rank(group)
        if N % W:
            raise ValueError(f"num views ({N}) must be divisible by the "
                             f"group's size ({W})")
        n = N // W
        sigmas = self._ladder(num_inference_steps, N, sampler, cameras.device)
        x = self._start(sigmas[0], (B, N, 2 * self.latent_channel, latent_hw,
                                    latent_hw), generator, noise,
                        cameras.device)
        local = slice(r * n, (r + 1) * n)
        out = self._sample_core(
            x[:, local].contiguous(), sigmas, cameras[:, local],
            text_embeddings, uncond_text_embeddings,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, guidance_type=guidance_type,
            cfg_rescale=cfg_rescale,
            view_mask=None if view_mask is None else view_mask[:, local],
            ref_latents=None if ref_latents is None else ref_latents[:, local],
            cfg_interval_frac=cfg_interval_frac, sampler=sampler,
            view_group=group)
        return all_gather_cat(out, 1, group)

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
            with profiling.span("sampler.step"):
                sigma, sigma_next = sigmas[i], sigmas[i + 1]
                use_3d = m > 0 and (num_inference_steps - 1 - i) % m == 0
                if use_3d:
                    out = self._guided_output(
                        x, sigma, text_embeddings, uncond_text_embeddings,
                        pose_emb, uncond_pose_emb, "none", 1.0, 0.0,
                        text_kv=kv_u)
                    x0 = self.schedule.denoise_output_to_x0(x, out, sigma)
                    gaussians = decode_gaussians(x0, cameras)
                    imgs, deps, _ = render_gaussians(
                        cameras, gaussians, h=render_size, w=render_size)
                    x0 = self.render_to_latent(imgs, deps)
                else:
                    out = self._guided_output(
                        x, sigma, text_embeddings, uncond_text_embeddings,
                        pose_emb, uncond_pose_emb, guidance_type,
                        guidance_scale, cfg_rescale, text_kv=kv_g)
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

    # -- training ----------------------------------------------------------
    def draw_multi_view(self, generator: torch.Generator | None, B: int,
                        N: int, hw: int, *, num_ref_views: int = 0,
                        drop_pose_p: float = 0.1, drop_text_p: float = 0.1,
                        sample_posterior: bool = True,
                        device: torch.device | str = "cpu",
                        rows: tuple | None = None,
                        view_generator: torch.Generator | None = None,
                        num_global_views: int | None = None) -> dict:
        """The random draws of one ``multi_view_loss``, from ``generator``
        with the JAX loss's distributions: ``sigmas (B,)`` (before the
        sigma adjustment), standard-normal ``noise (B, N, 8, hw, hw)``,
        ``ref_views`` (the first ``num_ref_views`` of a random permutation
        of the views), ``keep_pose (B,)`` and ``keep_text (B,)`` (a
        uniform draw at or above the drop probability), and
        ``encode_noise (B, 2N, 4, hw, hw)`` for the posterior sample (None:
        its mode).

        ``rows=(rank, world)`` (data parallel): the B scenes are rows
        ``[rank * B, (rank + 1) * B)`` of a global batch of ``world * B``;
        the draws are the global batch's, sliced, so the ranks together
        draw what one process draws. View sharding: ``view_generator``
        (seeded per rank) draws the per-view noise of the N local views,
        and the permutation spans ``num_global_views``."""
        g = dict(generator=generator, device=device)
        vg = g if view_generator is None else dict(generator=view_generator,
                                                   device=device)
        c = self.latent_channel
        r, W = rows or (0, 1)
        rows_of = lambda x: x[r * B:(r + 1) * B]     # noqa: E731
        Bg = B * W
        return {
            "sigmas": rows_of(self.schedule.sample_train_sigmas((Bg,), **g)),
            "noise": rows_of(torch.randn(Bg, N, 2 * c, hw, hw, **vg)),
            "ref_views": torch.randperm(num_global_views or N,
                                        **g)[:num_ref_views],
            "keep_pose": rows_of(torch.rand(Bg, **g) >= drop_pose_p),
            "keep_text": rows_of(torch.rand(Bg, **g) >= drop_text_p),
            "encode_noise": (rows_of(torch.randn(Bg, 2 * N, c, hw, hw, **vg))
                             if sample_posterior else None),
        }

    def multi_view_loss(self, batch: dict, *, num_ref_views: int = 0,
                        drop_pose_p: float = 0.1, drop_text_p: float = 0.1,
                        lambda_mse: float = 1.0,
                        lambda_mse_depth: float = 1.0,
                        return_aux: bool = False, draws: dict | None = None,
                        generator: torch.Generator | None = None,
                        sample_posterior: bool = True,
                        rows: tuple | None = None, view_group=None,
                        view_generator: torch.Generator | None = None):
        """The latent denoising loss on a multi-view batch: ``images_mv (B,
        N, 3, H, W)`` in [-1, 1], ``cameras_mv (B, N, 18)``, ``depths_mv
        (B, N, 1, H, W)`` pseudo-disparity in [0, 1], ``text_emb`` and
        ``uncond_text_emb (B, L, D)``.

        One encode of the 2N images (the depths repeated to 3 channels) by
        the frozen VAE; one sigma per scene; reference views (``view_cond``
        only) enter clean and are left out of the loss; per-scene pose and
        text dropout. The loss is the ``loss_weight``-weighted MSE of the
        x0 prediction on the image latents (channels 0-3) and the depth
        latents (4-7). ``draws`` (see ``draw_multi_view``) replaces the
        draws from ``generator`` (``rows``: see ``draw_multi_view``).
        Returns ``(loss, metrics)``, with ``return_aux`` also ``{"x0_pred":
        (B, N, 8, h, w)}``.

        ``view_group``: the N views are this rank's share of the scene's
        ``N * world`` (``multi_view_loss_view_sharded``); the reference
        views, the sigma adjustment and the denominators are global, the
        metrics are reduced over the group, and ``loss`` is this rank's
        term: the ranks' terms sum to the loss. Its per-view draws come
        from ``view_generator``.
        """
        images, cameras = batch["images_mv"], batch["cameras_mv"]
        depths = batch["depths_mv"]
        B, N = images.shape[:2]
        dev = images.device
        hw = images.shape[-1] // 2 ** (len(self.model.vae_ch_mult) - 1)
        W = 1 if view_group is None else world_size(view_group)
        n_global = N * W
        if draws is None:
            if view_group is not None and view_generator is None:
                raise ValueError("view-sharded draws need a view_generator "
                                 "seeded per rank")
            draws = self.draw_multi_view(
                generator, B, N, hw, num_ref_views=num_ref_views,
                drop_pose_p=drop_pose_p, drop_text_p=drop_text_p,
                sample_posterior=sample_posterior, device=dev, rows=rows,
                view_generator=view_generator, num_global_views=n_global)

        depths_in = (depths * 2.0 - 1.0).expand(-1, -1, 3, -1, -1)
        with torch.no_grad(), self._autocast(dev):
            lat = self.model.encode_image(torch.cat([images, depths_in], 1),
                                          draws["encode_noise"])
        x0 = torch.cat([lat[:, :N], lat[:, N:]], dim=2).float()
        h, w = x0.shape[-2:]

        is_ref = torch.zeros(n_global, dtype=torch.bool, device=dev)
        if self.noise_type == "view_cond" and num_ref_views > 0:
            is_ref[draws["ref_views"].to(dev)] = True
        if view_group is not None:
            r = get_rank(view_group)
            is_ref = is_ref[r * N:(r + 1) * N]
        ref_mask = is_ref[None, :, None, None, None]

        sigmas = draws["sigmas"].to(device=dev, dtype=torch.float32)
        if self.adjust_sigma_on_n:
            sigmas = sigmas / math.sqrt(self.num_pred_views / n_global)
        sig = sigmas[:, None, None, None, None]
        t_cond = self._t_cond(sigmas)[:, None].expand(B, N)

        noisy = self.schedule.add_noise(x0, draws["noise"].to(x0), sig)
        net_in = torch.where(ref_mask, x0, self.schedule.c_in(sig) * noisy)
        keep_pose = draws["keep_pose"].to(dev)[:, None, None, None, None]
        cond = make_raymap(cameras.float(), h, w) * keep_pose
        if self.noise_type == "view_cond":
            cond = torch.cat([cond, is_ref.to(cond.dtype)[
                None, :, None, None, None].expand(B, N, 1, h, w)], dim=2)
        net_in = torch.cat([net_in, cond], dim=2)
        keep_text = draws["keep_text"].to(dev)[:, None, None]
        text_emb = torch.where(keep_text, batch["text_emb"],
                               batch["uncond_text_emb"])

        with self._autocast(dev):
            pred = self.model.denoise(net_in, text_emb, t_cond,
                                      view_group=view_group)
        x0_pred = self.schedule.denoise_output_to_x0(noisy, pred.float(), sig)
        x0_pred = torch.where(ref_mask, x0, x0_pred)

        wgt = self.schedule.loss_weight(sig)
        tgt = (~is_ref).to(x0.dtype)[None, :, None, None, None]
        n_tgt = tgt.sum()
        reduce = (lambda ts: all_reduce_(ts, view_group)
                  ) if view_group is not None else (lambda ts: None)
        reduce([n_tgt])
        denom = torch.clamp_min(n_tgt * B / n_global, 1.0)

        def masked_mse(a, b):
            return (wgt * (a - b) ** 2 * tgt).sum() / (denom * a.shape[2]
                                                        * h * w)

        loss_mse = masked_mse(x0_pred[:, :, 0:4], x0[:, :, 0:4])
        loss_mse_depth = masked_mse(x0_pred[:, :, 4:8], x0[:, :, 4:8])
        loss = lambda_mse * loss_mse + lambda_mse_depth * loss_mse_depth
        metrics = {"loss_mv_latent_mse": loss_mse.detach().clone(),
                   "loss_mv_latent_mse_depth":
                       loss_mse_depth.detach().clone()}
        reduce(list(metrics.values()))

        # per-scene loss sums and counts by log10(sigma) bucket: the loss
        # varies ~25x with the drawn sigma alone
        with torch.no_grad():
            d = (x0_pred - x0) ** 2
            err = lambda_mse * d[:, :, 0:4].sum(2) \
                + lambda_mse_depth * d[:, :, 4:8].sum(2)        # (B, N, h, w)
            per_scene = (wgt[:, :, 0] * err * tgt[:, :, 0]).sum((1, 2, 3))
            per_scene_n = tgt[:, :, 0].expand(err.shape).sum((1, 2, 3))
            reduce([per_scene, per_scene_n])
            per_scene = per_scene / (torch.clamp_min(per_scene_n, 1.0) / 4.0)
            edges = torch.tensor(self.sigma_bucket_edges, device=dev)
            bucket = torch.searchsorted(
                edges, torch.log10(torch.clamp_min(sigmas, 1e-8)))
            for k in range(len(self.sigma_bucket_edges) + 1):
                in_k = (bucket == k).to(torch.float32)
                metrics[f"loss_sig_b{k}_sum"] = (per_scene * in_k).sum()
                metrics[f"loss_sig_b{k}_cnt"] = in_k.sum()
        if return_aux:
            return loss, metrics, {"x0_pred": x0_pred}
        return loss, metrics

    def multi_view_loss_view_sharded(
            self, group, batch: dict, *,
            generator: torch.Generator | None = None,
            view_generator: torch.Generator | None = None,
            noise: torch.Tensor | None = None, sample_posterior: bool = True,
            draws: dict | None = None, **loss_kw):
        """The sequence-parallel training loss: every rank passes the whole
        batch, keeps its ``N / world`` views of the ``*_mv`` leaves and runs
        ``multi_view_loss`` over ``group``. ``noise (B, N, 8, h, w)`` (the
        whole scene's, sliced here) and ``sample_posterior=False`` (the
        posterior's mode) are the seams that make it equal the single
        program's loss exactly; ``draws`` (a single program's, see
        ``draw_multi_view``) replaces every draw, its per-view tensors
        sliced here. Returns ``(this rank's term, metrics)``:
        backpropagate the term and sum the gradients over the ranks. Raises
        ``ValueError`` unless the world size divides N. ``group`` None is the
        world's group."""
        group = resolve_group(group)
        N = batch["images_mv"].shape[1]
        W, r = world_size(group), get_rank(group)
        if N % W:
            raise ValueError(f"num views ({N}) must be divisible by the "
                             f"group's size ({W})")
        local = shard_batch_views(batch, group)
        n = N // W
        if draws is not None:
            enc = draws.get("encode_noise")
            draws = dict(draws, noise=draws["noise"][:, r * n:(r + 1) * n],
                         encode_noise=None if enc is None else torch.cat(
                             [enc[:, r * n:(r + 1) * n],
                              enc[:, N + r * n:N + (r + 1) * n]], dim=1))
        elif noise is not None:
            B, dev = batch["images_mv"].shape[0], batch["images_mv"].device
            hw = noise.shape[-1]
            draws = self.draw_multi_view(
                generator, B, n, hw,
                num_ref_views=loss_kw.get("num_ref_views", 0),
                drop_pose_p=loss_kw.get("drop_pose_p", 0.1),
                drop_text_p=loss_kw.get("drop_text_p", 0.1),
                sample_posterior=sample_posterior, device=dev,
                view_generator=view_generator, num_global_views=N)
            draws["noise"] = noise[:, r * n:(r + 1) * n]
        return self.multi_view_loss(
            local, draws=draws, generator=generator,
            sample_posterior=sample_posterior, view_group=group,
            view_generator=view_generator, **loss_kw)

    def single_view_loss(self, batch: dict, dummy_camera: torch.Tensor, *,
                         draws: dict | None = None,
                         generator: torch.Generator | None = None, **kw):
        """The T2I batch: each of ``images_sv (B, M, 3, H, W)`` (with
        ``depths_sv``) is a 1-view scene with the fixed ``dummy_camera
        (18,)`` and its pose always dropped; ``text_emb_sv`` is per image
        ``(B, M, L, D)`` or shared ``(B, L, D)``. Metrics carry the ``sv_``
        prefix."""
        images = batch["images_sv"]
        B, M = images.shape[:2]
        emb = batch["text_emb_sv"]
        emb = (emb.reshape((B * M,) + emb.shape[2:]) if emb.dim() == 4
               else emb.repeat_interleave(M, dim=0))
        sv_batch = {
            "images_mv": images.reshape((B * M, 1) + images.shape[2:]),
            "depths_mv": batch["depths_sv"].reshape(
                (B * M, 1) + batch["depths_sv"].shape[2:]),
            "cameras_mv": dummy_camera.to(images.device).expand(B * M, 1, 18),
            "text_emb": emb,
            "uncond_text_emb": batch["uncond_text_emb"].repeat_interleave(
                M, dim=0),
        }
        if draws is not None:            # pose is always dropped
            draws = {**draws, "keep_pose": torch.zeros_like(
                draws["keep_pose"], dtype=torch.bool)}
        loss, metrics = self.multi_view_loss(
            sv_batch, drop_pose_p=1.0, draws=draws, generator=generator, **kw)
        return loss, {f"sv_{k}": v for k, v in metrics.items()}

    def rendering_loss(self, gs_system, latents_pred: torch.Tensor,
                       cameras: torch.Tensor, images_gt: torch.Tensor,
                       depths_gt: torch.Tensor, cameras_gt: torch.Tensor, *,
                       rendering_size: int = 256, lambda_mse: float = 1.0,
                       lambda_lpips: float = 0.0, lambda_depth: float = 0.5,
                       lpips_fn: Callable | None = None):
        """The end-to-end rendering loss through the frozen GS decoder of
        ``gs_system`` (eval mode: its EMANorms read their magnitudes) and
        the renderer: ``latents_pred (B, n, 8, h, w)`` x0 predictions of
        ``cameras (B, n, 18)`` -> gaussians -> renders of ``cameras_gt`` at
        ``rendering_size``, held against ``images_gt`` and the
        pseudo-disparity ``depths_gt`` (resized bilinearly, antialiased
        when they shrink). Image MSE, ``psnr_gs``, LPIPS (``lpips_fn``,
        when ``lambda_lpips``) and the scale-and-shift-invariant loss on
        the rendered disparity. Gradients reach ``latents_pred`` only.
        Returns ``(loss, metrics)``."""
        B, n, _, h, w = latents_pred.shape
        rs = rendering_size
        rm = make_raymap(cameras.float(), h, w).to(latents_pred.dtype)
        with self._autocast(latents_pred.device):
            raw = gs_system.model.decode_latent(
                torch.cat([latents_pred, rm], dim=2))
        gaussians = convert_gaussians(raw, cameras, **gs_system.gs_kwargs)
        imgs, deps, _ = render_gaussians(cameras_gt, gaussians, h=rs, w=rs)
        gt, gt_disp = resize_views(images_gt.float(), rs), \
            resize_views(depths_gt.float(), rs)

        metrics = {}
        loss_mse = ((imgs - gt) ** 2).mean()
        metrics["loss_gs_image_mse"] = loss_mse.detach()
        metrics["psnr_gs"] = psnr(imgs.detach(), gt)
        loss = lambda_mse * loss_mse
        if lambda_lpips and lpips_fn is not None:
            with self._autocast(imgs.device):
                loss_lpips = lpips_fn(imgs, gt).float()
            metrics["loss_gs_image_lpips"] = loss_lpips.detach()
            loss = loss + lambda_lpips * loss_lpips
        if lambda_depth:
            pred_disp = 1.0 / torch.clamp(deps, 0.1, 100.0)
            valid = (deps > 0.1).to(torch.float32)
            bn = B * cameras_gt.shape[1]
            loss_depth = scale_and_shift_invariant_loss(
                pred_disp.reshape(bn, rs, rs), gt_disp.reshape(bn, rs, rs),
                valid.reshape(bn, rs, rs))
            metrics["loss_gs_depth"] = loss_depth.detach()
            loss = loss + lambda_depth * loss_depth
        return loss, metrics


def scene_std(a: torch.Tensor, group=None) -> torch.Tensor:
    """The population std over dims 1-4 of each scene of ``a (B, n, ...)``:
    a two-pass mean and variance (``jnp.std``'s), each sum reduced over
    ``group``, whose ranks hold the scene's other views (None: the views
    are all here). One rank's group computes what no group does, bit for
    bit."""
    dims = (1, 2, 3, 4)
    count = a[0].numel() * (1 if group is None else world_size(group))
    total = a.sum(dim=dims, keepdim=True)
    if group is not None:
        all_reduce_([total], group)
    mean = total / count
    var = ((a - mean) ** 2).sum(dim=dims, keepdim=True)
    if group is not None:
        all_reduce_([var], group)
    return torch.sqrt(var / count)


def resize_views(x: torch.Tensor, size: int) -> torch.Tensor:
    """``(B, N, C, H, W)`` -> ``(B, N, C, size, size)``, bilinear with
    half-pixel centres, antialiased when it shrinks (``jax.image.resize``'s
    ``bilinear``); unchanged at ``size``."""
    if x.shape[-2:] == (size, size):
        return x
    flat = x.reshape((-1,) + x.shape[2:])
    out = F.interpolate(flat, size=(size, size), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.reshape(x.shape[:3] + (size, size))
