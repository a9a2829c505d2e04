"""TrajDiT sampling: text -> 29-camera trajectory by DDIM sample prediction
(``prometheus_tpu/systems/traj_dit_system.py``).

The DDIM state stays float32 for the whole loop: each step casts it to the
model's dtype for the network and upcasts the prediction before the update,
so a bf16 model never accumulates the 100 steps in bf16. The quaternion of
every prediction is renormalised before the step.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.traj_dit import TOKEN_DIM, TrajDiTModel, token_to_camera
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
