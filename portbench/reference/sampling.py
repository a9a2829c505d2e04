"""Frozen copies (commit 078c4a5) of the samplers' arithmetic:
``prometheus_torch/systems/mv_ldm_system.py`` (joint CFG with the
std-matching rescale, ``scene_std``, the Euler step),
``systems/gm_ldm_system.py`` (plain CFG), ``systems/traj_dit_system.py``
(TrajDiT's DDIM loop) and ``pipeline.py::default_camera_token``."""
from __future__ import annotations

import math

import torch

from .cameras import look_at, make_camera
from .schedulers import make_ddim, make_schedule
from .traj_dit import TOKEN_DIM, camera_to_token, token_to_camera

VPRED = make_schedule("vprediction")
TRAJ_DDIM = make_ddim(kind="scaled_linear", zero_snr=True)


def scene_std(a: torch.Tensor) -> torch.Tensor:
    """The population std over dims 1-4 of each scene of ``a (B, n, ...)``,
    two-pass."""
    dims = (1, 2, 3, 4)
    count = a[0].numel()
    mean = a.sum(dim=dims, keepdim=True) / count
    var = ((a - mean) ** 2).sum(dim=dims, keepdim=True)
    return torch.sqrt(var / count)


def joint_cfg(out: torch.Tensor, guidance_scale: float,
              cfg_rescale: float) -> torch.Tensor:
    """``out`` = the network's ``[cond, uncond]`` rows, float32 -> the
    guided output (``MVLDMSystem._guided_output``, joint guidance)."""
    cond, uncond = out.chunk(2, dim=0)
    guided = uncond + guidance_scale * (cond - uncond)
    if cfg_rescale > 0:
        factor = cfg_rescale * (scene_std(cond) / torch.clamp_min(
            scene_std(guided), 1e-8)) + (1.0 - cfg_rescale)
        guided = guided * factor
    return guided


def plain_cfg(out: torch.Tensor, guidance_scale: float) -> torch.Tensor:
    cond, uncond = out.chunk(2, dim=0)
    return uncond + guidance_scale * (cond - uncond)


def euler_from_output(x: torch.Tensor, guided: torch.Tensor,
                      sigma: torch.Tensor, sigma_next: torch.Tensor):
    """One Euler step of the v-prediction sampler from the guided output:
    ``(x0, x_next)``."""
    x0 = VPRED.denoise_output_to_x0(x, guided, sigma)
    return x0, VPRED.euler_step(x, x0, sigma, sigma_next)


def traj_step(x: torch.Tensor, pred: torch.Tensor, k: int,
              num_inference_steps: int = 100,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The DDIM update of TrajDiT's ``k``-th step from the state ``x`` and
    the network's prediction (its quaternion renormalised), computed in
    ``dtype`` (the program keeps the state in float32)."""
    sched = TRAJ_DDIM
    step = sched.num_train_timesteps // num_inference_steps
    t = sched.timesteps(num_inference_steps)[k]
    x, pred = x.to(dtype), pred.to(dtype)
    quat = pred[..., :4]
    quat = quat / torch.clamp_min(
        torch.linalg.norm(quat, dim=-1, keepdim=True), 1e-8)
    return sched.step(x, torch.cat([quat, pred[..., 4:]], dim=-1), t,
                      t - step)


def traj_tokens(model, text_embeddings: torch.Tensor, noise: torch.Tensor,
                num_inference_steps: int = 100) -> torch.Tensor:
    """TrajDiT's DDIM loop, state in float32: ``(B, 29, 11)`` tokens."""
    B, dev = text_embeddings.shape[0], text_embeddings.device
    x = noise.to(device=dev, dtype=torch.float32)
    sched = TRAJ_DDIM
    step = sched.num_train_timesteps // num_inference_steps
    for t in sched.timesteps(num_inference_steps):
        tb = torch.full((B,), float(t), device=dev)
        pred = model(x, text_embeddings, tb).float()
        quat = pred[..., :4]
        quat = quat / torch.clamp_min(
            torch.linalg.norm(quat, dim=-1, keepdim=True), 1e-8)
        pred = torch.cat([quat, pred[..., 4:]], dim=-1)
        x = sched.step(x, pred, t, t - step)
    return x


def trajectory(model, text_embeddings, noise, num_inference_steps: int = 100,
               image_size: int = 256) -> torch.Tensor:
    """``(B, 29, 18)`` cameras at ``image_size``^2."""
    return token_to_camera(traj_tokens(model, text_embeddings, noise,
                                       num_inference_steps), image_size)


def sparse_views(dense: torch.Tensor, num_views: int = 8) -> torch.Tensor:
    n = dense.shape[1]
    stride = max((n - 1) // (num_views - 1), 1)
    return dense[:, ::stride][:, :num_views]


def default_camera_token() -> torch.Tensor:
    """The token of a 60-degree camera two units from the origin, looking at
    it: what a random TrajDiT's output layer is centred on."""
    eye = torch.tensor([[0.0, 0.0, 2.0]])
    f = 0.5 / math.tan(math.radians(30.0))
    cam = make_camera(look_at(eye, torch.zeros_like(eye)), f, f, 0.5, 0.5,
                      1.0, 1.0)
    return camera_to_token(cam[None])[0, 0]


__all__ = ["TOKEN_DIM", "VPRED", "joint_cfg", "plain_cfg", "euler_from_output",
           "trajectory", "traj_step", "sparse_views", "default_camera_token", "scene_std"]
