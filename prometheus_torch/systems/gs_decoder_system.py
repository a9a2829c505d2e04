"""GS-decoder (stage-1) system: GS-VAE reconstruction training and
novel-view inference (``prometheus_tpu/systems/gs_decoder_system.py``).

The frozen VAE encoder embeds the input views (RGB and pseudo-depth); the
trainable cross-view DiT and VAE decoder emit pixel-aligned gaussians; the
NOVEL views are rendered and supervised with MSE and the
scale-and-shift-invariant disparity loss (and an opacity entropy term whose
weight is 0 by default). The stage-1 loss has no LPIPS term: the JAX
trainer builds this system without one (LPIPS, ``models/lpips.py``, serves
the stage-2 rendering loss).

Encoding noise is an argument, not a key: ``noise (B, N_in, 4, h, w)``
standard-normal, or None for the posterior's mode. As in the JAX system,
the rgb and the depth pass draw the SAME noise. With ``compute_dtype`` bf16
the networks run under autocast (bf16 compute, fp32 parameters: the
reference's ``bf16-mixed``); the converter, the renderer and the losses run
in fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..models.gs_decoder import GSDecoderModel
from ..ops.gaussian import convert_gaussians, render_gaussians
from ..utils.rays import raymap as make_raymap
from .depth_loss import scale_and_shift_invariant_loss


def psnr(pred: torch.Tensor, gt: torch.Tensor,
         data_range: float = 2.0) -> torch.Tensor:
    mse = ((pred - gt) ** 2).mean()
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp_min(mse, 1e-10))


@dataclasses.dataclass(eq=False)
class GSDecoderSystem:
    model: GSDecoderModel
    render_size: int = 256
    gs_kwargs: dict = dataclasses.field(
        default_factory=lambda: dict(z_near=0.01, z_far=100.0))
    render_bg_color: Any = None
    compute_dtype: torch.dtype = torch.float32

    def _autocast(self, device: torch.device):
        return torch.autocast(device_type=device.type, dtype=self.compute_dtype,
                              enabled=self.compute_dtype != torch.float32)

    def _decode(self, images_in, depths_in, cameras_in, noise=None,
                train: bool = False):
        """Input views -> gaussians; ``train`` updates the EMANorms."""
        depth3 = (depths_in * 2.0 - 1.0).repeat_interleave(3, dim=2)
        with self._autocast(images_in.device):
            with torch.no_grad():                       # frozen encoder
                lat_rgb = self.model.encode_image(images_in, noise)
                lat_depth = self.model.encode_image(depth3, noise)
        h, w = lat_rgb.shape[-2:]
        rm = make_raymap(cameras_in.to(torch.float32), h, w)
        latents_in = torch.cat([lat_rgb, lat_depth, rm.to(lat_rgb.dtype)],
                               dim=2)
        with self._autocast(images_in.device):
            raw = self.model.decode_latent(latents_in, train=train)
        return convert_gaussians(raw, cameras_in, **self.gs_kwargs)

    def loss(self, batch: dict, *, num_input_views: int = 4,
             lambda_mse: float = 1.0, lambda_depth: float = 0.5,
             lambda_entropy: float = 0.0, render_size: int | None = None):
        """``batch``: ``images_mv (B, N_in + N_nv, 3, H, W)`` in [-1, 1],
        ``cameras_mv (B, N, 18)``, ``depths_mv (B, N, 1, H, W)``
        pseudo-disparity in [0, 1], and optionally ``encode_noise (B, N_in,
        4, H/8, W/8)``. Returns ``(loss, metrics)``; the EMANorm buffers are
        updated in place."""
        images, cameras, depths = (batch["images_mv"], batch["cameras_mv"],
                                   batch["depths_mv"])
        rs = render_size or self.render_size
        n_in = num_input_views
        gaussians = self._decode(images[:, :n_in], depths[:, :n_in],
                                 cameras[:, :n_in], batch.get("encode_noise"),
                                 train=True)
        # render and supervise the NOVEL views only
        imgs_nv, deps_nv, masks_nv = render_gaussians(
            cameras[:, n_in:], gaussians, h=rs, w=rs,
            bg_color=self.render_bg_color)
        gt_nv = images[:, n_in:].to(torch.float32)
        gt_disp_nv = depths[:, n_in:].to(torch.float32)

        # zero-weight terms are skipped, as in the JAX system
        loss = imgs_nv.new_zeros(())
        metrics = {"psnr_mv": psnr(imgs_nv.detach(), gt_nv)}
        loss_mse = ((imgs_nv - gt_nv) ** 2).mean()
        metrics["loss_mv_image_mse"] = loss_mse.detach()
        if lambda_mse:
            loss = loss + lambda_mse * loss_mse
        if lambda_depth:
            # the render gives metric depth; supervise its inverse
            pred_disp = 1.0 / torch.clamp(deps_nv, 0.1, 100.0)
            valid = (deps_nv > 0.1).to(torch.float32)
            bn = pred_disp.shape[0] * pred_disp.shape[1]
            loss_depth = scale_and_shift_invariant_loss(
                pred_disp.reshape(bn, rs, rs), gt_disp_nv.reshape(bn, rs, rs),
                valid.reshape(bn, rs, rs))
            metrics["loss_mv_depth"] = loss_depth.detach()
            loss = loss + lambda_depth * loss_depth
        if lambda_entropy:
            loss_entropy = (1.0 - masks_nv).mean()
            metrics["loss_mv_entropy"] = loss_entropy.detach()
            loss = loss + lambda_entropy * loss_entropy
        return loss, metrics

    @torch.no_grad()
    def inference(self, images_in, depths_in, cameras_in, cameras_nv,
                  noise=None, render_size: int | None = None) -> dict:
        """Input views -> gaussians -> renders of ``cameras_nv``. With
        ``noise`` None the encoder takes the posterior's mode; the JAX
        system, given no key, samples with ``PRNGKey(0)``, so pass that
        key's normal draw as ``noise`` to reproduce it."""
        rs = render_size or self.render_size
        gaussians = self._decode(images_in, depths_in, cameras_in, noise)
        imgs, deps, masks = render_gaussians(
            cameras_nv, gaussians, h=rs, w=rs, bg_color=self.render_bg_color)
        return {"gaussians": gaussians, "images_nv_pred": imgs,
                "depths_nv_pred": deps, "masks_nv_pred": masks}
