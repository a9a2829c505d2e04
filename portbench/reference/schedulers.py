# Frozen copy of prometheus_torch/ops/schedulers.py at commit 078c4a5; imports
# rewritten to this package, kernel A replaced by plain attention.
"""Diffusion schedules (``prometheus_tpu/ops/schedulers.py``).

The MV-LDM sampler's EDM form: ``x_t = x0 + sigma * eps`` (variance
exploding); callers scale by ``c_in`` before the network and read
``x0 = c_skip * x_t + c_out * F``. The regimes: ``vprediction`` (linear
betas, zero-terminal-SNR rescale, v-prediction preconditioning; the
flagship), ``eprediction`` (scaled-linear betas, epsilon preconditioning)
and ``edm`` (Karras sigmas, or the high-noise exponential ladder). The
samplers step by Euler or by DPM-Solver++(2M); training draws its sigmas
with ``sample_train_sigmas``.

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


def sigmas_from_alphas_cumprod(alphas_cumprod: np.ndarray) -> np.ndarray:
    """``sigma_t = sqrt((1 - abar_t) / abar_t)``, ascending in t."""
    return np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A sigma-parameterised schedule with the EDM preconditioning table:
    ``x0 = c_skip(s) x_t + c_out(s) F(c_in(s) x_t, c_noise(s))``.

    ``kind`` is ``vprediction`` or ``eprediction`` (a beta table in
    ``train_sigmas``) or ``edm`` (no table; training sigmas are lognormal
    with ``p_mean`` and ``p_std``). The coefficient functions take sigma
    as a tensor.
    """

    kind: str
    num_train_timesteps: int
    prediction_type: str                # 'v_prediction' | 'epsilon'
    train_sigmas: np.ndarray | None = None   # float32 sigma(t), ascending
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    rho: float = 7.0
    sigma_schedule: str = "karras"      # 'karras' | 'exponential' (edm)
    p_mean: float = -0.5
    p_std: float = 1.2
    sigma_data: float = 1.0

    def c_skip(self, s):
        sd = self.sigma_data
        return sd**2 / (s**2 + sd**2)

    def c_out(self, s):
        if self.kind == "vprediction":
            return -s / torch.sqrt(s**2 + 1)
        if self.kind == "eprediction":
            return s / torch.sqrt(s**2 + 1)
        sd = self.sigma_data
        return s * sd / torch.sqrt(s**2 + sd**2)

    def c_in(self, s):
        return 1.0 / torch.sqrt(s**2 + self.sigma_data**2)

    def c_noise(self, s):
        return torch.log(s) / 4.0

    def loss_weight(self, s):
        sd = self.sigma_data
        return (s**2 + sd**2) / (s * sd) ** 2

    def sample_train_sigmas(self, shape, generator: torch.Generator | None = None,
                            device: torch.device | str | None = None
                            ) -> torch.Tensor:
        """Training noise levels: the table's sigma at a uniform integer
        timestep in ``[0, num_train_timesteps)``, or without a table
        (``edm``) ``exp(p_mean + p_std * N(0, 1))``; float32."""
        if self.train_sigmas is not None:
            t = torch.randint(0, self.num_train_timesteps, tuple(shape),
                              generator=generator, device=device)
            return torch.from_numpy(self.train_sigmas).to(t.device)[t]
        return torch.exp(self.p_mean + self.p_std * torch.randn(
            tuple(shape), generator=generator, device=device))

    def add_noise(self, x0, noise, sigma):
        """Variance-exploding noising; apply ``c_in`` before the network."""
        return x0 + sigma * noise

    def denoise_output_to_x0(self, x_t, model_out, sigma):
        return self.c_skip(sigma) * x_t + self.c_out(sigma) * model_out

    def x0_to_target(self, x_t, x0, sigma):
        """The network's regression target for ``x0`` (the inverse of the
        x0 readout)."""
        return (x0 - self.c_skip(sigma) * x_t) / self.c_out(sigma)

    def inference_sigmas(self, num_steps: int,
                         ladder: str = "default") -> torch.Tensor:
        """Descending float32 ladder with a trailing 0 (``num_steps + 1``
        entries), computed in float64. A beta table's default ladder is
        linspace in timestep over the table; ``ladder='karras'`` spaces
        rho-7 Karras steps between the table's ends (the multistep
        sampler's ladder). EDM uses its own Karras or exponential ladder.
        """
        if self.train_sigmas is not None and ladder != "karras":
            n = self.num_train_timesteps
            ts = np.linspace(0, n - 1, num_steps)[::-1].copy()
            sig = np.interp(ts, np.arange(n), self.train_sigmas)
        elif self.train_sigmas is not None or self.sigma_schedule == "karras":
            if self.train_sigmas is not None:
                lo = float(self.train_sigmas[0])
                hi = float(self.train_sigmas[-1])
            else:
                lo, hi = self.sigma_min, self.sigma_max
            i = np.linspace(0, 1, num_steps)
            inv_rho = 1.0 / self.rho
            sig = (hi**inv_rho + i * (lo**inv_rho - hi**inv_rho)) ** self.rho
        elif self.sigma_schedule == "exponential":
            sig = np.exp(np.linspace(np.log(self.sigma_max),
                                     np.log(self.sigma_min), num_steps))
        else:
            raise ValueError(self.sigma_schedule)
        return torch.tensor(np.concatenate([sig, [0.0]]), dtype=torch.float32)

    def euler_step(self, x_t, x0_pred, sigma, sigma_next):
        """First-order ODE step in sigma space."""
        d = (x_t - x0_pred) / sigma
        return x_t + (sigma_next - sigma) * d

    def dpmpp_2m_step(self, x_t, x0_pred, x0_prev, sigma_prev, sigma,
                      sigma_next, has_prev: bool):
        """One DPM-Solver++(2M) update (data prediction, ``lambda = -log
        sigma``). ``x0_prev`` and ``sigma_prev`` are the previous step's;
        without one (``has_prev`` false) it is the first-order step
        ``x0 + (s_next / s) (x - x0)``. ``sigma_next == 0`` returns x0."""
        sn = torch.clamp_min(sigma_next, 1e-20)
        h = torch.log(sigma) - torch.log(sn)
        h_last = torch.log(torch.clamp_min(sigma_prev, 1e-20)) \
            - torch.log(sigma)
        if has_prev:
            r = torch.clamp_min(h_last / h, 1e-6)
            d = (1.0 + 1.0 / (2.0 * r)) * x0_pred - (1.0 / (2.0 * r)) * x0_prev
        else:
            d = x0_pred
        return (sigma_next / sigma) * x_t - torch.expm1(-h) * d


def make_schedule(kind: str = "vprediction", *, high_noise: bool = False,
                  sigma_data: float = 1.0,
                  num_train_timesteps: int = 1000) -> Schedule:
    """``vprediction`` (linear betas) and ``eprediction`` (scaled-linear
    betas), both rescaled to zero terminal SNR, with their float32 sigma
    tables computed in float64; ``edm`` with Karras sigmas in [0.002, 80]
    or, with ``high_noise``, the exponential ladder up to 1e4 with
    lognormal (1.5, 2.0) training sigmas."""
    if kind in ("vprediction", "eprediction"):
        ab = rescale_zero_terminal_snr(alphas_cumprod_from_betas(make_betas(
            num_train_timesteps,
            kind="linear" if kind == "vprediction" else "scaled_linear")))
        return Schedule(
            kind=kind, num_train_timesteps=num_train_timesteps,
            prediction_type=("v_prediction" if kind == "vprediction"
                             else "epsilon"),
            train_sigmas=sigmas_from_alphas_cumprod(ab).astype(np.float32))
    if kind == "edm":
        common = dict(kind="edm", num_train_timesteps=num_train_timesteps,
                      prediction_type="epsilon", sigma_data=sigma_data)
        if high_noise:
            return Schedule(**common, sigma_max=10000.0,
                            sigma_schedule="exponential", p_mean=1.5,
                            p_std=2.0)
        return Schedule(**common)
    raise ValueError(f"unknown schedule kind: {kind}")


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
