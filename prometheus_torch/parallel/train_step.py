"""Train step: gradient accumulation, global-norm clipping, AdamW, EMA
(``prometheus_tpu/parallel/train_step.py``, one device, no frozen mask).

The semantics are optax's ``chain(clip_by_global_norm, adamw)`` as the JAX
step applies them: the gradients of every parameter are clipped by their
global norm (left as they are below the limit, scaled to it above), then
AdamW takes a decoupled weight-decay step (eps 1e-8 outside the square
root, bias-corrected moments, fp32). ``grad_norm`` is the norm before
clipping. Every parameter takes part, the frozen VAE encoder too: its
gradient is zero but weight decay still moves it, as optax does when the
JAX step runs without a frozen mask. The EMA covers every parameter.
Mutable model state (the EMANorm magnitudes) lives in the module's buffers
and is updated in place by the loss, micro-batch after micro-batch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    """Parameters and model state (the module), optimizer, EMA copy."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema_params: dict[str, torch.Tensor]


def make_optimizer(params, learning_rate: float = 1e-5,
                   weight_decay: float = 1e-4,
                   betas=(0.9, 0.95)) -> torch.optim.AdamW:
    """AdamW with fp32 moments (the JAX default ``mu_dtype=None``; its bf16
    first moment is not ported)."""
    return torch.optim.AdamW(list(params), lr=learning_rate,
                             betas=tuple(betas), eps=1e-8,
                             weight_decay=weight_decay)


def init_train_state(model: nn.Module,
                     optimizer: torch.optim.Optimizer) -> TrainState:
    return TrainState(0, model, optimizer,
                      {n: p.detach().clone() for n, p in model.named_parameters()})


def global_norm(tensors) -> torch.Tensor:
    """The fp32 L2 norm of all ``tensors`` together (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


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
            if p.grad is None:            # frozen: zero gradient, still decayed
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        factor = torch.where(norm < grad_clip, torch.ones_like(norm),
                             grad_clip / norm)
        for g in grads:
            g.mul_(factor.to(g.dtype))
        opt.step()
        with torch.no_grad():
            for name, p in state.model.named_parameters():
                state.ema_params[name].mul_(ema_decay).add_(
                    p, alpha=1.0 - ema_decay)
        state.step += 1
        metrics = dict(metrics)
        metrics["loss"] = total / grad_accum
        metrics["grad_norm"] = norm
        return metrics

    return train_step
