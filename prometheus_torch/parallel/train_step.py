"""Train step: gradient accumulation, global-norm clipping, AdamW, EMA, and
the frozen-parameter mask (``prometheus_tpu/parallel/train_step.py``, one
device).

The semantics are optax's ``chain(clip_by_global_norm, adamw)`` as the JAX
step applies them: the gradients of every trained parameter are clipped by
their global norm (left as they are below the limit, scaled to it above),
then AdamW takes a decoupled weight-decay step (eps 1e-8 outside the square
root, bias-corrected moments). ``grad_norm`` is the norm before clipping.

``AdamW(mu_dtype=torch.bfloat16)`` is optax's ``scale_by_adam(mu_dtype=
bf16)`` in the jitted JAX step: the new first moment ``b1 * mu + (1 - b1) *
g`` is formed in fp32 from the stored bf16 moment (with ``b1`` rounded to
bf16, as JAX's weak typing rounds it), the update uses that fp32 moment, and
only then is it rounded to bf16 and stored; the second moment stays fp32.

A ``frozen`` predicate on parameter names (stage 2: the VAE and the CLIP
text tower) takes those parameters out of the step: they are
``requires_grad_(False)``, outside the optimizer, the clip norm and the EMA,
and never change. Without one (stage 1) every parameter takes part, the
frozen VAE encoder too: its gradient is zero, yet weight decay still moves
it, as optax does when the JAX step runs without a frozen mask. The EMA
covers exactly the parameters the optimizer holds. Mutable model state (the
EMANorm magnitudes) lives in the module's buffers and is updated in place
by the loss, micro-batch after micro-batch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

# elements of fp32 temporaries one AdamW chunk may hold (256 MiB): the update
# runs over groups of tensors so its transient memory stays bounded
_CHUNK_ELEMS = 1 << 26


@dataclasses.dataclass
class TrainState:
    """Parameters and model state (the module), optimizer, EMA copy of the
    trained parameters."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema_params: dict[str, torch.Tensor]


def frozen_components(*components: str) -> Callable[[str], bool]:
    """The predicate that freezes a parameter whose dotted name has a
    component among ``components`` (``train.py``'s stage-2 mask: ``vae``
    and ``text_encoder``)."""
    return lambda name: any(part in components for part in name.split("."))


def _chunks(tensors: list):
    """Consecutive index ranges of ``tensors`` of at most ``_CHUNK_ELEMS``
    elements each (a larger tensor alone)."""
    start, size = 0, 0
    for i, t in enumerate(tensors):
        if size and size + t.numel() > _CHUNK_ELEMS:
            yield start, i
            start, size = i, 0
        size += t.numel()
    if start < len(tensors):
        yield start, len(tensors)


class AdamW(torch.optim.Optimizer):
    """optax's ``adamw`` with ``mu_dtype``: state ``exp_avg`` (the first
    moment, in ``mu_dtype`` or fp32) and ``exp_avg_sq`` (fp32), one step
    count for all parameters, the bias corrections in float32 as optax
    computes them."""

    def __init__(self, params, lr: float = 1e-5, betas=(0.9, 0.95),
                 eps: float = 1e-8, weight_decay: float = 1e-4,
                 mu_dtype: torch.dtype | None = None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p] = dict(
                        step=torch.zeros((), dtype=torch.int64),
                        exp_avg=torch.zeros_like(
                            p, dtype=self.mu_dtype or p.dtype),
                        exp_avg_sq=torch.zeros_like(p))
                self.state[p]["step"] += 1
            count = int(self.state[params[0]]["step"])
            self._update(group, params, count)

    def _update(self, group, params, count: int) -> None:
        b1, b2 = group["betas"]
        lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
        f32 = np.float32
        c1 = float(f32(1) - f32(b1) ** count)
        c2 = float(f32(1) - f32(b2) ** count)
        for lo, hi in _chunks(params):
            ps = params[lo:hi]
            g = [p.grad for p in ps]
            mu = [self.state[p]["exp_avg"] for p in ps]
            nu = [self.state[p]["exp_avg_sq"] for p in ps]
            # (1 - b1) g + b1 mu in fp32, as the jitted JAX step computes
            # it: b1 is rounded to mu's dtype first (a Python float is
            # weakly typed in JAX: 0.9 is 0.8984375 in bf16), the product
            # is not
            m = torch._foreach_mul(g, 1.0 - b1)
            torch._foreach_add_(m, torch._foreach_mul(
                [x.float() for x in mu],
                float(torch.tensor(b1, dtype=mu[0].dtype))))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(g, g), 1.0 - b2))
            den = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            upd = torch._foreach_div(m, c1)
            torch._foreach_div_(upd, den)
            del den
            if wd:
                torch._foreach_add_(upd, torch._foreach_mul(ps, wd))
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(ps, upd)
            # only now is the fp32 moment rounded to mu's dtype
            torch._foreach_copy_(mu, m)

    def load_state_dict(self, state_dict) -> None:
        """As ``Optimizer.load_state_dict``, which casts every state tensor
        to its parameter's dtype; the first moments return to ``mu_dtype``
        (bf16 -> fp32 -> bf16 loses nothing)."""
        super().load_state_dict(state_dict)
        if self.mu_dtype is not None:
            for st in self.state.values():
                st["exp_avg"] = st["exp_avg"].to(self.mu_dtype)


def make_optimizer(params, learning_rate: float = 1e-5,
                   weight_decay: float = 1e-4, betas=(0.9, 0.95),
                   mu_dtype: torch.dtype | None = None) -> AdamW:
    """AdamW over ``params`` (the trained ones); ``mu_dtype=torch.bfloat16``
    stores the first moment in bf16 (the JAX trainer's default), None keeps
    it fp32."""
    return AdamW(list(params), lr=learning_rate, betas=betas, eps=1e-8,
                 weight_decay=weight_decay, mu_dtype=mu_dtype)


def freeze_(model: nn.Module, frozen: Callable[[str], bool] | None) -> list:
    """``requires_grad_(False)`` on the parameters ``frozen`` names; returns
    the others' tensors, the ones to train."""
    trained = []
    for name, p in model.named_parameters():
        if frozen is not None and frozen(name):
            p.requires_grad_(False)
        else:
            trained.append(p)
    return trained


def init_train_state(model: nn.Module,
                     optimizer: torch.optim.Optimizer) -> TrainState:
    """Step 0 and an EMA copy of exactly the parameters ``optimizer``
    holds."""
    held = {id(p) for group in optimizer.param_groups for p in group["params"]}
    return TrainState(0, model, optimizer,
                      {n: p.detach().clone() for n, p in model.named_parameters()
                       if id(p) in held})


def full_ema_params(model: nn.Module,
                    ema_params: dict[str, torch.Tensor]) -> dict:
    """Every parameter of ``model`` by name: its EMA value where the EMA
    tracks it, the live value elsewhere (the frozen towers)."""
    return {n: ema_params.get(n, p.detach())
            for n, p in model.named_parameters()}


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm of all ``tensors`` together (``optax.global_norm``), in
    their dtype (the trainers' gradients are fp32)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        list(tensors))))


def _micro_batches(batch: dict, n: int):
    """Split every leaf's leading (batch) axis into ``n`` contiguous
    micro-batches, as the JAX step's reshape to ``(n, B // n, ...)``."""
    size = next(iter(batch.values())).shape[0]
    if size % n:
        raise ValueError(f"batch of {size} does not split into {n} "
                         "micro-batches")
    return [{k: v[i * (size // n):(i + 1) * (size // n)]
             for k, v in batch.items()} for i in range(n)]


def make_train_step(loss_fn: Callable, opt: torch.optim.Optimizer,
                    ema_decay: float = 0.9999, grad_accum: int = 1,
                    grad_clip: float = 1.0) -> Callable:
    """``loss_fn(batch) -> (loss, metrics)`` on the module the optimizer
    holds. Returns ``train_step(state, batch) -> metrics``, which updates
    ``state`` in place; with ``grad_accum > 1`` the batch's leading axis
    splits into that many micro-batches, gradients are averaged and the
    metrics are the last micro-batch's."""

    def train_step(state: TrainState, batch: dict) -> dict:
        params = [p for group in opt.param_groups for p in group["params"]]
        for p in params:
            p.grad = None
        total = 0.0
        for mb in _micro_batches(batch, grad_accum):
            loss, metrics = loss_fn(mb)
            (loss / grad_accum).backward()
            total = total + loss.detach()
        for p in params:
            if p.grad is None:            # no gradient reached it: zero
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        # optax's arithmetic: t / norm * clip above the limit, t below it
        # (t / 1 * 1), without a host sync
        below = norm < grad_clip
        one = torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(below, one, norm))
        torch._foreach_mul_(grads, torch.where(below, one, one * grad_clip))
        opt.step()
        with torch.no_grad():
            named = dict(state.model.named_parameters())
            ema = list(state.ema_params.values())
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, [named[n] for n in state.ema_params],
                                alpha=1.0 - ema_decay)
        state.step += 1
        metrics = dict(metrics)
        metrics["loss"] = total / grad_accum
        metrics["grad_norm"] = norm
        return metrics

    return train_step
