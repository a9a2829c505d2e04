"""TrajDiT sampling: text -> 29-camera trajectory by DDIM sample prediction
(``prometheus_tpu/systems/traj_dit_system.py``).

The DDIM state stays float32 for the whole loop: each step casts it to the
model's dtype for the network and upcasts the prediction before the update,
so a bf16 model never accumulates the 100 steps in bf16. The quaternion of
every prediction is renormalised before the step.

``loss`` is the training objective: sample-prediction MSE on camera tokens
noised at a uniform integer timestep; ``t`` and ``noise`` are inputs for
parity, drawn from a ``torch.Generator`` when absent.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import profiling
from ..models.traj_dit import (TOKEN_DIM, TrajDiTModel, camera_to_token,
                               token_to_camera)
from ..ops.schedulers import DDIMSchedule, make_ddim


@dataclasses.dataclass(eq=False)
class TrajDiTSystem:
    model: TrajDiTModel
    schedule: DDIMSchedule = dataclasses.field(
        default_factory=lambda: make_ddim(kind="scaled_linear",
                                          zero_snr=True))
    num_tokens: int = 29

    @torch.no_grad()
    def sample_tokens(self, text_embeddings: torch.Tensor,
                      generator: torch.Generator | None = None,
                      num_inference_steps: int = 100,
                      noise: torch.Tensor | None = None) -> torch.Tensor:
        """``text_embeddings (B, L, D)`` -> denoised tokens ``(B, 29, 11)``
        float32, from ``noise`` (standard normal) or a draw from
        ``generator``."""
        B = text_embeddings.shape[0]
        dev = text_embeddings.device
        if noise is None:
            noise = torch.randn((B, self.num_tokens, TOKEN_DIM),
                                generator=generator, device=dev)
        x = noise.to(device=dev, dtype=torch.float32)
        step = self.schedule.num_train_timesteps // num_inference_steps
        for t in self.schedule.timesteps(num_inference_steps):
            with profiling.span("traj.step"):
                tb = torch.full((B,), float(t), device=dev)
                pred = self.model(x, text_embeddings, tb).float()
                quat = pred[..., :4]
                quat = quat / torch.clamp_min(
                    torch.linalg.norm(quat, dim=-1, keepdim=True), 1e-8)
                pred = torch.cat([quat, pred[..., 4:]], dim=-1)
                x = self.schedule.step(x, pred, t, t - step)
        return x

    @torch.no_grad()
    def inference(self, text_embeddings: torch.Tensor,
                  generator: torch.Generator | None = None,
                  num_inference_steps: int = 100, image_size: int = 512,
                  noise: torch.Tensor | None = None) -> torch.Tensor:
        """``(B, 29, 18)`` camera trajectory at ``image_size``^2."""
        tokens = self.sample_tokens(text_embeddings, generator,
                                    num_inference_steps, noise)
        return token_to_camera(tokens, image_size=image_size)

    def loss(self, cameras: torch.Tensor, text_embeddings: torch.Tensor,
             t: torch.Tensor | None = None, noise: torch.Tensor | None = None,
             generator: torch.Generator | None = None,
             compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """``cameras (B, 29, 18)``, ``text_embeddings (B, L, D)`` -> the
        MSE of the model's sample prediction from ``sqrt(ab_t) tokens +
        sqrt(1 - ab_t) noise``; ``t (B,)`` integer timesteps and standard
        normal ``noise`` are drawn from ``generator`` unless given. The
        model runs under autocast in ``compute_dtype``."""
        tokens = camera_to_token(cameras.float())
        B, dev = tokens.shape[0], tokens.device
        if t is None:
            t = torch.randint(0, self.schedule.num_train_timesteps, (B,),
                              generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(tokens.shape, generator=generator, device=dev)
        ab = self.schedule.alphas_cumprod.to(dev)[t.to(dev)][:, None, None]
        noisy = torch.sqrt(ab) * tokens + torch.sqrt(1 - ab) * noise.to(dev)
        with torch.autocast(device_type=dev.type, dtype=compute_dtype,
                            enabled=compute_dtype != torch.float32):
            pred = self.model(noisy, text_embeddings, t.to(dev).float())
        return ((pred.float() - tokens) ** 2).mean()
