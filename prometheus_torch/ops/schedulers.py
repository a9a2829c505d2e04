"""Diffusion schedules (``prometheus_tpu/ops/schedulers.py``).

The MV-LDM sampler's EDM form: ``x_t = x0 + sigma * eps`` (variance
exploding); callers scale by ``c_in`` before the network and read
``x0 = c_skip * x_t + c_out * F``. Of those regimes only the one the
flagship sampler uses is ported: ``vprediction`` (linear betas,
zero-terminal-SNR rescale, v-prediction preconditioning).

``DDIMSchedule`` is the alpha-bar form of TrajDiT's deterministic
sample-prediction sampler (``make_ddim``: scaled-linear betas, optionally
rescaled to zero terminal SNR).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def make_betas(num_steps: int = 1000, beta_start: float = 0.00085,
               beta_end: float = 0.012, kind: str = "linear") -> np.ndarray:
    """Linear or scaled-linear (linear in sqrt(beta)) betas, float64."""
    if kind == "linear":
        return np.linspace(beta_start, beta_end, num_steps, dtype=np.float64)
    if kind == "scaled_linear":
        return np.linspace(beta_start**0.5, beta_end**0.5, num_steps,
                           dtype=np.float64) ** 2
    raise ValueError(kind)


def alphas_cumprod_from_betas(betas: np.ndarray) -> np.ndarray:
    return np.cumprod(1.0 - betas)


def rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """Zero terminal SNR, with the last entry clamped to 2^-24."""
    ab_sqrt = np.sqrt(alphas_cumprod)
    a0, aT = ab_sqrt[0], ab_sqrt[-1]
    ab_sqrt = (ab_sqrt - aT) * a0 / (a0 - aT)
    out = ab_sqrt**2
    out[-1] = 2.0**-24
    return out


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A beta-table schedule with EDM preconditioning."""

    num_train_timesteps: int
    train_sigmas: np.ndarray       # float32 sigma(t), ascending in t

    def c_skip(self, s):
        return 1.0 / (s**2 + 1)

    def c_out(self, s):
        return -s / torch.sqrt(s**2 + 1)

    def c_in(self, s):
        return 1.0 / torch.sqrt(s**2 + 1)

    def c_noise(self, s):
        return torch.log(s) / 4.0

    def denoise_output_to_x0(self, x_t, model_out, sigma):
        return self.c_skip(sigma) * x_t + self.c_out(sigma) * model_out

    def inference_sigmas(self, num_steps: int) -> torch.Tensor:
        """Descending float32 ladder (linspace in timestep) with a trailing 0."""
        n = self.num_train_timesteps
        ts = np.linspace(0, n - 1, num_steps)[::-1].copy()
        sig = np.interp(ts, np.arange(n), self.train_sigmas)
        return torch.tensor(np.concatenate([sig, [0.0]]), dtype=torch.float32)

    def euler_step(self, x_t, x0_pred, sigma, sigma_next):
        """First-order ODE step in sigma space."""
        d = (x_t - x0_pred) / sigma
        return x_t + (sigma_next - sigma) * d


def make_schedule(kind: str = "vprediction",
                  num_train_timesteps: int = 1000) -> Schedule:
    if kind != "vprediction":
        raise NotImplementedError(
            f"schedule {kind!r} is not ported yet (see ROADMAP.md)")
    ab = rescale_zero_terminal_snr(alphas_cumprod_from_betas(make_betas(
        num_train_timesteps)))
    table = np.sqrt((1.0 - ab) / ab).astype(np.float32)
    return Schedule(num_train_timesteps=num_train_timesteps,
                    train_sigmas=table)


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Deterministic (eta 0) DDIM over an alpha-bar table."""

    alphas_cumprod: torch.Tensor       # (N,) float32, ascending in t
    num_train_timesteps: int = 1000

    def timesteps(self, num_steps: int, steps_offset: int = 9) -> list[int]:
        """Descending timesteps: leading spacing ``arange(n) * (N // n)``
        plus ``steps_offset``, clipped to ``[0, N - 1]``."""
        n = self.num_train_timesteps
        ts = (np.arange(num_steps) * (n // num_steps))[::-1] + steps_offset
        return np.clip(ts, 0, n - 1).tolist()

    def _ab(self, t: int) -> torch.Tensor:
        """ᾱ_t as a 0-d float32 CPU tensor, which acts as a scalar on any
        device; 1 where ``t < 0``."""
        return self.alphas_cumprod[t] if t >= 0 else torch.ones(())

    def add_noise(self, x0, noise, t: int):
        ab = self._ab(t)
        return torch.sqrt(ab) * x0 + torch.sqrt(1 - ab) * noise

    def step(self, x_t, x0_pred, t: int, t_prev: int):
        """One deterministic DDIM update given a sample prediction."""
        ab_t, ab_prev = self._ab(t), self._ab(t_prev)
        eps = (x_t - torch.sqrt(ab_t) * x0_pred) / torch.sqrt(1 - ab_t)
        return torch.sqrt(ab_prev) * x0_pred + torch.sqrt(1 - ab_prev) * eps


def make_ddim(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
              beta_end: float = 0.012, kind: str = "scaled_linear",
              zero_snr: bool = False) -> DDIMSchedule:
    """The alpha-bar table is computed in float64 and stored as float32."""
    ab = alphas_cumprod_from_betas(make_betas(num_train_timesteps, beta_start,
                                              beta_end, kind))
    if zero_snr:
        ab = rescale_zero_terminal_snr(ab)
    return DDIMSchedule(torch.tensor(ab, dtype=torch.float32),
                        num_train_timesteps)


def cfg_combine(uncond: torch.Tensor, cond: torch.Tensor,
                scale: float) -> torch.Tensor:
    return uncond + scale * (cond - uncond)


def cfg_rescale(guided: torch.Tensor, cond: torch.Tensor, rescale: float = 0.7,
                dim=(1, 2, 3)) -> torch.Tensor:
    """Std-matching CFG rescale (Lin et al. 2023): blend the guided
    prediction towards one with the conditional prediction's std."""
    std_cond = torch.std(cond, dim=dim, keepdim=True, correction=0)
    std_guided = torch.std(guided, dim=dim, keepdim=True, correction=0)
    rescaled = guided * (std_cond / torch.clamp_min(std_guided, 1e-8))
    return rescale * rescaled + (1.0 - rescale) * guided
