"""PrometheusPipeline: text -> camera trajectory -> MV-LDM latents -> 3D
Gaussians -> renders (``prometheus_tpu/pipeline.py``).

``generate`` runs CLIP text encoding, TrajDiT's DDIM sampler for a
29-camera trajectory cut to the sparse views (unless the caller gives
``cameras``), the MV-LDM sampler (Euler or DPM-Solver++(2M), any guidance
type, CFG rescale, optionally guidance on a high-noise interval or 3D mode),
the VAE 2-D decode of images and depths, the GS decoder with
``convert_gaussians``, ``render_views_chunked`` through the compositor
kernel and, with a refiner from ``build_refiner``, test-time SDS++
refinement of the gaussians. ``generate_image_to_3d`` conditions on CLIP
image embeddings of reference images instead of text and pins the
reference views to their clean RGB-D latents (``attach_image_to_3d`` gives
a pipeline its seeded random image tower and depth teacher).
``render_orbit_video`` renders the slerp-resampled trajectory for the video
export. Over a process group, ``generate(view_shard_group=...)`` splits
each scene's views over the ranks (``MVLDMSystem.sample_view_sharded``,
then ``decode_and_render_view_sharded``: the GS decoder's DiT gathers K and
V over the ranks, one gather of the gaussians, each rank renders its own
views), and ``render_orbit_video(group=...)`` splits the frames; every
rank gets the whole result. ``build_pipeline`` is the counterpart of
``bench.py::build_flagship``: flagship width (or the small test width)
with seeded random weights; ``load_checkpoint`` then loads trained
weights (a release bundle or a published ``full.ckpt``), as the JAX CLI's
``--ckpt`` does.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import torch
from torch import nn

from . import profiling
from .models import (CLIPImageEncoder, CLIPTokenizer, GSDecoderModel,
                     MVLDMModel, TrajDiTModel, make_depth_fn)
from .models.traj_dit import camera_to_token
from .ops.gaussian import convert_gaussians, render_gaussians
from .parallel.dist import (all_gather_cat, broadcast_, get_rank,
                            resolve_group, world_size)
from .systems import MVLDMSystem, TrajDiTSystem
from .utils import (look_at, make_camera, resolve_device,
                    sample_from_dense_cameras)
from .utils.rays import raymap as make_raymap
from .weights import init_random_, random_module

# the reduced widths of ``bench.py::build_flagship(small=True)``
SMALL_MVLDM = dict(model_channels=64, num_head_channels=32, context_dim=64,
                   channel_mult=(1, 2), num_res_blocks=1,
                   disable_3d_attentions=(1, 0, 0, 0, 0), clip_layers=2,
                   clip_width=64, vae_ch=32, vae_ch_mult=(1, 2, 4),
                   image_size=64)
SMALL_GSDECODER = dict(dit_hidden_size=64, dit_depth=2, dit_num_heads=4,
                       vae_ch=32, vae_ch_mult=(1, 2, 4))
SMALL_TRAJ = dict(hidden_size=64, num_blocks=2, num_heads=4, text_dim=64)
# the reduced image tower of ``inference.py --small`` (proj_dim: the
# MV-LDM's context_dim)
SMALL_CLIP_IMAGE = dict(image_size=28, width=64, num_heads=4, num_layers=2)


def stage_timer(device: torch.device, timings: dict) -> Callable:
    """``mark(stage)`` records the seconds since the previous mark (or
    since this call) under ``stage``, the card synchronised first, and
    the same interval as the tracer's ``prometheus.stage.<stage>`` span
    (``profiling.stage``)."""
    t0, w0 = time.perf_counter(), profiling.now_ns()

    def mark(stage: str) -> None:
        nonlocal t0, w0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1, w1 = time.perf_counter(), profiling.now_ns()
        timings[stage] = t1 - t0
        profiling.stage(stage, w0, w1)
        t0, w0 = t1, w1

    return mark


@dataclasses.dataclass(eq=False)
class PrometheusPipeline:
    """The MV-LDM system, the GS decoder and the TrajDiT system (the
    ``full.ckpt`` analogue). Without ``traj``, ``generate`` needs
    ``cameras``. ``image_encoder`` (a ``CLIPImageEncoder``) and ``depth_fn``
    (``make_depth_fn``'s) serve ``generate_image_to_3d``."""

    mvldm: MVLDMSystem
    gsdecoder: GSDecoderModel
    traj: TrajDiTSystem | None = None
    tokenizer: CLIPTokenizer = dataclasses.field(
        default_factory=CLIPTokenizer)
    gs_kwargs: dict = dataclasses.field(default_factory=lambda: dict(
        z_near=0.01, z_far=100.0, s_min=0.001, s_max=1.0))
    image_encoder: nn.Module | None = None
    depth_fn: Callable | None = None

    @property
    def device(self) -> torch.device:
        return self.gsdecoder.vae.post_quant_conv.weight.device

    @torch.no_grad()
    def encode_text(self, texts) -> torch.Tensor:
        ids = torch.from_numpy(self.tokenizer(texts)).to(self.device)
        return self.mvldm.encode_text(ids)

    def generate_trajectory(self, text_embeddings: torch.Tensor,
                            generator: torch.Generator | None = None,
                            num_steps: int = 100, image_size: int = 512,
                            noise: torch.Tensor | None = None) -> torch.Tensor:
        """``(B, L, D)`` text embeddings -> ``(B, 29, 18)`` dense cameras."""
        if self.traj is None:
            raise ValueError("this pipeline has no TrajDiT stage; pass "
                             "cameras to generate")
        return self.traj.inference(text_embeddings, generator,
                                   num_inference_steps=num_steps,
                                   image_size=image_size, noise=noise)

    @staticmethod
    def sparse_views(dense_cameras: torch.Tensor,
                     num_views: int = 8) -> torch.Tensor:
        """Stride-subsample the trajectory so the views span it end to end:
        stride ``(n - 1) // (v - 1)``, so 29 cameras give 0, 4, ..., 28."""
        n = dense_cameras.shape[1]
        if num_views <= 1:
            return dense_cameras[:, :1]
        stride = max((n - 1) // (num_views - 1), 1)
        return dense_cameras[:, ::stride][:, :num_views]

    @torch.no_grad()
    def decode_gaussians(self, latents: torch.Tensor, cameras: torch.Tensor):
        """x0 RGB-D latents ``(B, N, 8, h, w)`` + cameras -> gaussian tuple."""
        h, w = latents.shape[-2:]
        rm = make_raymap(cameras, h, w).to(latents.dtype)
        raw = self.gsdecoder.decode_latent(torch.cat([latents, rm], dim=2))
        return convert_gaussians(raw, cameras, **self.gs_kwargs)

    @torch.no_grad()
    def generate(self, text, cameras: torch.Tensor | None = None,
                 generator: torch.Generator | None = None,
                 num_views: int = 8, num_inference_steps: int = 50,
                 num_traj_steps: int = 100, guidance_scale: float = 7.5,
                 guidance_type: str = "joint", cfg_rescale: float = 0.7,
                 render_size: int = 512, image_size: int = 512,
                 negative_text: str = "", latent_hw: int | None = None,
                 render_tile_capacity: int = 1024,
                 noise: torch.Tensor | None = None,
                 traj_noise: torch.Tensor | None = None,
                 sampler: str = "euler",
                 cfg_interval_frac: float | None = None,
                 use_3d_mode_every_m_steps: int = -1,
                 refiner=None, view_shard_group=None) -> dict:
        """Text -> 3DGS scene.

        Without ``cameras``, TrajDiT samples a 29-camera trajectory at
        ``image_size``^2 in ``num_traj_steps`` DDIM steps and
        ``sparse_views`` cuts it to ``num_views`` cameras; with ``cameras
        (B, N, 18)`` those are used and are also the dense cameras.
        ``traj_noise`` ``(B, 29, 11)`` and ``noise`` ``(B, N, 8, h, w)``:
        the two samplers' standard-normal starts, drawn from ``generator``
        (trajectory first) when not given.

        ``sampler`` (``euler`` or ``dpmpp_2m``) and ``cfg_interval_frac``
        select the sampler's mode; ``use_3d_mode_every_m_steps > 0`` runs
        ``MVLDMSystem.sample_with_3d_mode`` (Euler with full-interval
        guidance only: anything else raises ``ValueError``), rendering at
        the latent grid times the VAE's stride. A ``refiner``
        (``build_refiner``) refines the first scene's gaussians from its
        dense cameras, drawing from ``generator``, and adds
        ``gaussians_sds``, ``images_sds_gs_render`` and
        ``depths_sds_gs_render``. Returns the result dict of the JAX
        pipeline plus ``timings``: seconds per stage (the card is
        synchronised at each stage boundary).

        ``view_shard_group`` (a process group; ``dist.group.WORLD`` for the
        world): every rank passes the same arguments, and the sampler and
        the decode and render run view-sharded over its ranks; each rank
        returns the whole result. It refuses 3D mode, whose re-render is
        not sharded (as in JAX).
        """
        if view_shard_group is not None and use_3d_mode_every_m_steps > 0:
            raise ValueError("view_shard_group is not supported together "
                             "with use_3d_mode_every_m_steps (3D-mode "
                             "re-render is not view-sharded)")
        if use_3d_mode_every_m_steps > 0 and (
                sampler != "euler" or cfg_interval_frac is not None):
            raise ValueError("use_3d_mode_every_m_steps supports only "
                             "sampler='euler' with full-interval CFG "
                             f"(got sampler={sampler!r}, "
                             f"cfg_interval_frac={cfg_interval_frac!r})")
        if isinstance(text, str):
            text = [text]
        with profiling.span("t2s.batch", unit=True, batch=len(text)):
            dev = self.device
            timings = {}
            mark = stage_timer(dev, timings)
            text_emb = self.encode_text(text)
            uncond_emb = self.encode_text([negative_text]).expand(
                text_emb.shape)
            if view_shard_group is not None:
                # one text embedding for every rank: the fallback tokenizer's
                # ids differ between processes
                uncond_emb = uncond_emb.contiguous()
                broadcast_([text_emb, uncond_emb], view_shard_group)
            mark("encode_text")
            if cameras is None:
                dense = self.generate_trajectory(
                    text_emb, generator, num_steps=num_traj_steps,
                    image_size=image_size, noise=traj_noise)
                cameras = self.sparse_views(dense, num_views)
                mark("trajectory")
            else:
                cameras = cameras.to(device=dev, dtype=torch.float32)
                dense = cameras
            hw = latent_hw or self.mvldm.model.latent_size
            kw = dict(generator=generator,
                      num_inference_steps=num_inference_steps,
                      guidance_scale=guidance_scale,
                      guidance_type=guidance_type,
                      cfg_rescale=cfg_rescale, latent_hw=hw, noise=noise)
            if use_3d_mode_every_m_steps > 0:
                model = self.mvldm.model
                latents = self.mvldm.sample_with_3d_mode(
                    self.decode_gaussians, cameras, text_emb, uncond_emb,
                    use_3d_mode_every_m_steps=use_3d_mode_every_m_steps,
                    render_size=hw * (model.image_size // model.latent_size),
                    **kw)
            elif view_shard_group is not None:
                latents = self.mvldm.sample_view_sharded(
                    view_shard_group, cameras, text_emb, uncond_emb,
                    sampler=sampler, cfg_interval_frac=cfg_interval_frac, **kw)
            else:
                latents = self.mvldm.sample(
                    cameras, text_emb, uncond_emb, sampler=sampler,
                    cfg_interval_frac=cfg_interval_frac, **kw)
            mark("sample")
            if view_shard_group is not None:
                result = self.decode_and_render_view_sharded(
                    view_shard_group, latents, cameras,
                    render_size=render_size,
                    tile_capacity=render_tile_capacity, mark=mark)
                result["dense_cameras"] = dense
            else:
                result = self._decode_and_render(
                    latents, cameras, dense, render_size, mark,
                    tile_capacity=render_tile_capacity)
            if refiner is not None:
                gaussians_sds = refiner.refine_gaussians(
                    result["gaussians"], text_emb[:1], uncond_emb[:1], dense,
                    generator=generator)
                img_sds, dep_sds, _ = self.render_views_chunked(
                    cameras, gaussians_sds, h=render_size, w=render_size)
                result.update(gaussians_sds=gaussians_sds,
                              images_sds_gs_render=img_sds,
                              depths_sds_gs_render=dep_sds)
                mark("refine")
            result["timings"] = timings
            return result

    @torch.no_grad()
    def generate_image_to_3d(self, ref_images: torch.Tensor,
                             cameras: torch.Tensor,
                             generator: torch.Generator | None = None,
                             ref_idx: tuple = (0,),
                             num_inference_steps: int = 50,
                             guidance_scale: float = 7.5,
                             cfg_rescale: float = 0.7, render_size: int = 512,
                             latent_hw: int | None = None,
                             noise: torch.Tensor | None = None) -> dict:
        """Image -> 3DGS scene (the reference's ``mv_ldm_system.py:865-905``).

        ``ref_images (B, R, 3, H, W)`` in [-1, 1], ``cameras (B, N, 18)``
        whose views ``ref_idx[k]`` are reference ``k``'s. The CLIP image
        embeddings of the references (one token each) replace the text,
        those of an all-zero image the negative text; the reference views'
        x0 are pinned at every step (``view_mask``, ``ref_latents``) to their
        clean RGB-D latents ``encode_image(ref) | encode_image(repeat(disp
        * 2 - 1, 3))``, ``disp`` from ``depth_fn``. Joint CFG with rescale,
        then the 2-D decode, the gaussians and the renders, as in
        ``generate``. ``noise (B, N, 8, h, w)``: the sampler's
        standard-normal start, drawn from ``generator`` when not given.
        Returns ``generate``'s result dict (``dense_cameras`` are the
        cameras) with the seconds of ``image_encoder``, ``depth``,
        ``encode_refs``, ``sample``, ``decode_2d``, ``decode_gaussians`` and
        ``render`` under ``timings``.
        """
        if self.image_encoder is None or self.depth_fn is None:
            raise ValueError("image-to-3D needs image_encoder and depth_fn "
                             "(attach_image_to_3d)")
        with profiling.span("t2s.batch", unit=True,
                            batch=ref_images.shape[0]):
            dev = self.device
            timings = {}
            mark = stage_timer(dev, timings)
            ref_images = ref_images.to(device=dev, dtype=torch.float32)
            cameras = cameras.to(device=dev, dtype=torch.float32)
            B, N = cameras.shape[:2]
            R = ref_images.shape[1]
            hw = latent_hw or self.mvldm.model.latent_size
            flat = ref_images.reshape((B * R,) + ref_images.shape[2:])
            cond = self.image_encoder(flat).reshape(B, R, -1)
            uncond = self.image_encoder(torch.zeros_like(flat)).reshape(
                B, R, -1)
            mark("image_encoder")
            disp = self.depth_fn(ref_images)
            mark("depth")
            encode = self.mvldm.model.encode_image
            ref_rd = torch.cat([encode(ref_images),
                                encode((disp * 2.0 - 1.0).repeat(1, 1, 3, 1,
                                                                  1))],
                               dim=2)
            view_mask = torch.zeros(B, N, 1, hw, hw, device=dev)
            ref_latents = torch.zeros((B, N) + ref_rd.shape[2:], device=dev,
                                      dtype=ref_rd.dtype)
            for k, idx in enumerate(ref_idx):
                view_mask[:, idx] = 1.0
                ref_latents[:, idx] = ref_rd[:, k]
            mark("encode_refs")
            latents = self.mvldm.sample(
                cameras, cond, uncond, generator=generator,
                num_inference_steps=num_inference_steps,
                guidance_scale=guidance_scale, guidance_type="joint",
                cfg_rescale=cfg_rescale, latent_hw=hw, noise=noise,
                view_mask=view_mask, ref_latents=ref_latents)
            mark("sample")
            result = self._decode_and_render(latents, cameras, cameras,
                                             render_size, mark)
            result["timings"] = timings
            return result

    def _decode_and_render(self, latents: torch.Tensor, cameras: torch.Tensor,
                           dense: torch.Tensor, render_size: int,
                           mark: Callable, **render_kw) -> dict:
        """Sampled latents -> the 2-D decode, the gaussians and their renders
        at ``render_size``^2 (``render_kw`` to ``render_views_chunked``): the
        result dict shared by ``generate`` and ``generate_image_to_3d``."""
        images_pred, depths_pred = self.mvldm.decode_images_and_depths(latents)
        mark("decode_2d")
        gaussians = self.decode_gaussians(latents, cameras)
        mark("decode_gaussians")
        images_gs, depths_gs, masks_gs = self.render_views_chunked(
            cameras, gaussians, h=render_size, w=render_size, **render_kw)
        mark("render")
        return {"cameras": cameras, "dense_cameras": dense,
                "latents_pred": latents, "images_pred": images_pred,
                "depths_pred": depths_pred, "gaussians": gaussians,
                "images_gs_render": images_gs, "depths_gs_render": depths_gs,
                "masks_gs_render": masks_gs}

    @torch.no_grad()
    def decode_and_render_view_sharded(self, group, latents: torch.Tensor,
                                       cameras: torch.Tensor, *,
                                       render_size: int = 512,
                                       tile_capacity: int = 1024,
                                       mark: Callable | None = None) -> dict:
        """The view-sharded tail of ``generate``: each rank of ``group``
        (None: the world's) takes its ``N / world`` views of the whole
        ``latents (B, N, 8, h, w)`` and ``cameras (B, N, 18)``, decodes them
        in 2-D and through the GS decoder (its DiT gathering K and V over
        the ranks), converts them to gaussians, gathers every rank's
        gaussians once and renders its own views of the whole scene
        through the compositor. The outputs are gathered: every rank
        returns ``_decode_and_render``'s dict, view for view."""
        group = resolve_group(group)
        mark = mark or (lambda stage: None)
        B, N = cameras.shape[:2]
        W, r = world_size(group), get_rank(group)
        if N % W:
            raise ValueError(f"num views ({N}) must be divisible by the "
                             f"group's size ({W})")
        local = slice(r * (N // W), (r + 1) * (N // W))
        lat, cams = latents[:, local], cameras[:, local]
        imgs, deps = self.mvldm.decode_images_and_depths(lat)
        mark("decode_2d")
        h, w = lat.shape[-2:]
        rm = make_raymap(cams, h, w).to(lat.dtype)
        raw = self.gsdecoder.decode_latent(torch.cat([lat, rm], dim=2),
                                           view_group=group)
        gaussians = tuple(all_gather_cat(g, 1, group) for g in
                          convert_gaussians(raw, cams, **self.gs_kwargs))
        mark("decode_gaussians")
        renders = self.render_views_chunked(
            cams, gaussians, h=render_size, w=render_size,
            tile_capacity=tile_capacity)
        imgs, deps, ri, rd, rmask = (all_gather_cat(x, 1, group) for x in
                                     (imgs, deps) + renders)
        mark("render")
        return {"cameras": cameras, "dense_cameras": cameras,
                "latents_pred": latents, "images_pred": imgs,
                "depths_pred": deps, "gaussians": gaussians,
                "images_gs_render": ri, "depths_gs_render": rd,
                "masks_gs_render": rmask}

    def build_refiner(self, kind: str = "mv_sds", **overrides):
        """A test-time SDS++ refiner on this pipeline's towers, its weights
        frozen (``requires_grad_(False)``).

        ``kind='mv_sds'``: guidance by the MV-LDM itself (joint multi-view
        RGB-D SDS). ``kind='sds'``: single-view SDS++ whose 2-D guidance is
        the MV-LDM run as a 1-view model with zeroed depth-latent, raymap
        and mask channels: VP-noisy latents at a DDPM timestep (the
        scaled-linear table) are taken to the VE form, denoised at
        ``_t_cond(sigma)`` and read out as eps. ``overrides`` set the
        refiner's fields (``total_iterations``, ``img_size``, ...).
        """
        from .ops.schedulers import make_ddim
        from .refiners import GSRefinerSDSPlusPlus, MultiviewSDSPPRefiner

        system = self.mvldm
        model = system.model.requires_grad_(False)

        def encode_fn(images):          # (V, 3, H, W) -> (V, 4, h, w)
            return model.encode_image(images[None])[0]

        def decode_fn(latents):         # (V, 4, h, w) -> (V, 3, H, W)
            return model.decode_latent(latents[None])[0].float()

        if kind == "mv_sds":
            kw = dict(encode_fn=encode_fn, decode_fn=decode_fn,
                      denoise_fn=None, mvldm_system=system)
            kw.update(overrides)
            return MultiviewSDSPPRefiner(**kw)
        if kind != "sds":
            raise ValueError(f"unknown refiner kind: {kind}")
        sched = system.schedule
        n_cond = model.extra_latent_channel
        ab_table = make_ddim(kind="scaled_linear").alphas_cumprod

        def denoise_fn(lat_noisy_vp, t, emb):
            """VP-noisy ``(B, 4, h, w)`` at integer ``t (B,)`` -> eps."""
            ab = ab_table.to(lat_noisy_vp.device)[t][:, None, None, None]
            sigma = torch.sqrt((1.0 - ab) / ab)
            x_ve = lat_noisy_vp / sched.c_in(sigma)
            B = lat_noisy_vp.shape[0]
            pad = lat_noisy_vp.new_zeros((B, n_cond)
                                         + lat_noisy_vp.shape[2:])
            net_in = torch.cat([lat_noisy_vp, pad], dim=1)[:, None]
            tc = system._t_cond(sigma[:, 0, 0, 0])[:, None]
            out = model.denoise(net_in, emb, tc)[:, 0, :4].float()
            x0 = sched.c_skip(sigma) * x_ve + sched.c_out(sigma) * out
            return (x_ve - x0) / torch.clamp_min(sigma, 1e-8)

        kw = dict(encode_fn=encode_fn, decode_fn=decode_fn,
                  denoise_fn=denoise_fn)
        kw.update(overrides)
        return GSRefinerSDSPlusPlus(**kw)

    @staticmethod
    @torch.no_grad()
    def render_views_chunked(cameras: torch.Tensor, gaussians, h: int, w: int,
                             chunk: int | None = None, bg_color=None,
                             tile_capacity: int = 1024):
        """Render the ``(B, N)`` views ``chunk`` at a time (default: all of
        them, one compositor launch)."""
        N = cameras.shape[1]
        chunk = N if chunk is None else chunk
        outs = [render_gaussians(cameras[:, i:i + chunk], gaussians, h=h, w=w,
                                 bg_color=bg_color,
                                 tile_capacity=tile_capacity)
                for i in range(0, N, chunk)]
        return tuple(torch.cat([o[k] for o in outs], dim=1) for k in range(3))

    @torch.no_grad()
    def render_orbit_video(self, gaussians, dense_cameras: torch.Tensor,
                           num_frames: int = 120, size: int = 512,
                           chunk: int = 8,
                           tile_capacity: int = 512,
                           group=None) -> torch.Tensor:
        """Render the first scene's trajectory, slerp-resampled to
        ``num_frames`` cameras, ``chunk`` frames a compositor launch ->
        ``(T, 3, size, size)`` float32 in [-1, 1] on the CPU.

        ``group``: the frames split over its ranks (the cameras padded
        with the last one to a multiple of the world size, each rank
        rendering its share); the gathered frames, cut back to
        ``num_frames``, on every rank.

        Tile capacity 512 is the JAX package's choice for this display
        path (``PERF.md`` holds the port's ``psnr_vs_exact`` readings at
        512 and 1024).
        """
        t = torch.linspace(0, 1, num_frames,
                           device=dense_cameras.device)[None]
        cams = sample_from_dense_cameras(
            dense_cameras[:1].to(torch.float32), t)
        g1 = tuple(g[:1] for g in gaussians)
        if group is None:
            frames = [render_gaussians(cams[:, i:i + chunk], g1, h=size,
                                       w=size, tile_capacity=tile_capacity
                                       )[0][0].cpu()
                      for i in range(0, num_frames, chunk)]
            return torch.cat(frames, dim=0)
        W, r = world_size(group), get_rank(group)
        pad = -num_frames % W
        cams = torch.cat([cams, cams[:, -1:].expand(1, pad, 18)], dim=1)
        per = cams.shape[1] // W
        mine = cams[:, r * per:(r + 1) * per]
        frames = torch.cat([render_gaussians(mine[:, i:i + chunk], g1,
                                             h=size, w=size,
                                             tile_capacity=tile_capacity
                                             )[0][0]
                            for i in range(0, per, chunk)], dim=0)
        return all_gather_cat(frames, 0, group)[:num_frames].cpu()


def default_camera_token() -> torch.Tensor:
    """The token of a 60-degree camera two units from the origin, looking at
    it: what the random TrajDiT's output layer is centred on."""
    eye = torch.tensor([[0.0, 0.0, 2.0]])
    f = 0.5 / math.tan(math.radians(30.0))
    cam = make_camera(look_at(eye, torch.zeros_like(eye)), f, f, 0.5, 0.5,
                      1.0, 1.0)
    return camera_to_token(cam[None])[0, 0]


def build_pipeline(small: bool = False, device: str | torch.device = "cuda",
                   dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                   widths: dict | None = None) -> PrometheusPipeline:
    """The flagship-width pipeline (SD-2.1 U-Net at 256^2 image / 32^2
    latent, CLIP ViT-H text tower, GS decoder with its 16-block cross-view
    DiT, TrajDiT of 8 blocks at width 512) or, with ``small``, the reduced
    test widths; a tower named in ``widths`` (``{"mvldm", "gsdecoder",
    "traj"}`` constructor kwargs, a bundle's ``checkpoint.bundle_widths``)
    takes those instead. Seeded random weights (``weights.random_module``)
    in ``dtype`` on ``device``.

    TrajDiT's output layer is then scaled by 0.1 and its bias set to
    ``default_camera_token()``, so that the random trajectory's cameras
    stay clear of ``token_to_camera``'s guards (a zero-mean output would
    clamp half the focal lengths to ``1e-3 * image_size``).
    """
    device = resolve_device(device)
    widths = {"mvldm": SMALL_MVLDM if small else dict(image_size=256),
              "gsdecoder": SMALL_GSDECODER if small else {},
              "traj": SMALL_TRAJ if small else {},
              **{k: v for k, v in (widths or {}).items() if v is not None}}
    g = torch.Generator(device=device).manual_seed(seed)
    mv, gs, traj = (random_module(cls, widths[name], device, g)
                    for cls, name in ((MVLDMModel, "mvldm"),
                                      (GSDecoderModel, "gsdecoder"),
                                      (TrajDiTModel, "traj")))
    with torch.no_grad():
        traj.out_block.weight.mul_(0.1)
        traj.out_block.bias.copy_(default_camera_token())
    for m in (mv, gs, traj):
        m.to(dtype).eval()
    return PrometheusPipeline(mvldm=MVLDMSystem(model=mv), gsdecoder=gs,
                              traj=TrajDiTSystem(model=traj))


def attach_image_to_3d(pipe: PrometheusPipeline, small: bool = False,
                       seed: int = 0) -> PrometheusPipeline:
    """Give ``pipe`` a seeded random CLIP image tower in its own dtype (ViT-H
    at full width, ``SMALL_CLIP_IMAGE`` with ``small``; projected to the
    MV-LDM's ``context_dim``) and a seeded random float32 DA2-Small depth
    teacher (``make_depth_fn``), on its device."""
    dev = pipe.device
    model = pipe.mvldm.model
    with torch.device("meta"):
        enc = CLIPImageEncoder(proj_dim=model.context_dim,
                               **(SMALL_CLIP_IMAGE if small else {}))
    enc.to_empty(device=dev)
    init_random_(enc, torch.Generator(device=dev).manual_seed(seed))
    pipe.image_encoder = enc.to(model.unet.conv_in.weight.dtype).eval()
    pipe.depth_fn = make_depth_fn(device=dev, seed=seed)
    return pipe


def load_checkpoint(pipe: PrometheusPipeline,
                    path: str | None) -> dict | None:
    """Trained weights for ``pipe`` (the ``--ckpt`` of the JAX CLIs'
    ``build_pipeline``), cast to its dtype on its device.

    A directory is the port's release bundle (``checkpoint.load_bundle``:
    strict, its widths must be ``pipe``'s; ``inference.pipeline_from_args``
    builds the pipeline from the bundle's widths). A file is the reference's
    published ``full.ckpt``, converted in place through ``weight_maps.py``
    (``checkpoint.convert_bundle(checkpoint.split_full_ckpt(path), pipe)``,
    which unpickles it: read only trusted files); each tower prints ``N
    tensors converted, M skipped``, and a WARNING with the first 5
    unconverted entries where there are any. No ``path``, or one that does
    not exist, leaves the random weights and says so, as the JAX CLI does.
    Returns the conversion's report for a ``full.ckpt``, else None.
    """
    import os

    from .checkpoint import convert_bundle, load_bundle, split_full_ckpt

    if not path or not os.path.exists(path):
        print("[inference] no checkpoint given/found - using random weights")
        return None
    t0 = time.perf_counter()
    if os.path.isdir(path):
        load_bundle(path, pipe)
        print(f"[inference] loaded the bundle {path} in "
              f"{time.perf_counter() - t0:.1f}s")
        return None
    report = convert_bundle(split_full_ckpt(path), pipe)
    for tower, r in report.items():
        bad = (r.get("missing", []) + r.get("unassigned", [])
               + r.get("unmapped", []))
        if bad:
            print(f"[inference] WARNING: {tower}: {len(bad)} unconverted "
                  f"entries, e.g. {bad[:5]}")
        print(f"[inference] {tower}: {r['mapped']} tensors converted, "
              f"{len(r.get('skipped', []))} skipped")
    return report
