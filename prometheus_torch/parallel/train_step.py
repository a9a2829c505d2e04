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

Over a process group (``make_train_step(group=...)``), each rank computes
the gradients of its own batch and they are reduced with coalesced
``all_reduce`` before the clip: averaged for data parallelism (``reduce=
"mean"``; every rank's loss is the mean over equal local batches, so the
average is the global batch's gradient), summed for view sharding
(``reduce="sum"``: each rank's loss is its term over the global
denominators). The metrics are reduced alike (``*_sum`` and ``*_cnt``
summed). The model's floating buffers (the EMANorm magnitudes, which each
rank moves on its own batch) are averaged after the step. ``ZeroShards``
(``--param_sharding fsdp``, a hand-written ZeRO) splits the optimizer
state and the EMA of each trained parameter of 2^16 elements or more on
``fsdp_param_spec``'s dim over its group: the reduced gradient's local
slice updates the local slice of the parameter, and the slices are
gathered back into the whole parameter the networks compute with; smaller
parameters stay replicated, updated alike on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from .. import profiling
from .dist import (all_gather_cat, all_reduce_, fsdp_param_spec, get_rank,
                   world_size)

# parameters of at least this many elements are split under
# --param_sharding fsdp (``fsdp_param_spec``'s threshold); smaller ones stay
# replicated
FSDP_MIN_SIZE = 2 ** 16
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
    sharding: ZeroShards | None = None

    def full_ema(self) -> dict[str, torch.Tensor]:
        """The EMA of every tracked parameter, whole (gathered over the
        sharding group: every rank of it must call)."""
        if self.sharding is None:
            return self.ema_params
        return {n: self.sharding.gather(n, v)
                for n, v in self.ema_params.items()}


class ZeroShards:
    """``--param_sharding fsdp`` over ``group`` (None: the world's): the
    trained ``named`` parameters' split dims (``fsdp_param_spec`` at
    ``FSDP_MIN_SIZE``), this rank's slices (``shards``: copies the
    optimizer and the EMA hold; the parameter itself where it stays
    whole), the gradients' slices before the update and the gathered
    slices after it."""

    def __init__(self, named: list, group=None):
        self.group = group
        self.world, self.rank = world_size(group), get_rank(group)
        self.params = dict(named)
        self.dims = {n: fsdp_param_spec(p.shape, self.world, FSDP_MIN_SIZE)
                     for n, p in named}
        self.shards = {n: p if self.dims[n] is None
                       else self.local(n, p.detach()).clone()
                       for n, p in named}

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        d = self.dims[name]
        return full if d is None else full.chunk(self.world, d)[self.rank]

    def gather(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        d = self.dims[name]
        return shard if d is None else all_gather_cat(shard, d, self.group)

    def sharded(self) -> list[str]:
        return [n for n, d in self.dims.items() if d is not None]

    def take_grads(self) -> None:
        for n in self.sharded():
            self.shards[n].grad = self.local(n, self.params[n].grad)

    @torch.no_grad()
    def put_params(self) -> None:
        """Every rank's updated slices into the whole parameters."""
        for n in self.sharded():
            self.params[n].copy_(self.gather(n, self.shards[n]))
            self.shards[n].grad = None

    @torch.no_grad()
    def reload(self) -> None:
        """The slices from the whole parameters (after a restore)."""
        for n in self.sharded():
            self.shards[n].copy_(self.local(n, self.params[n]))


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


def init_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                     sharding: ZeroShards | None = None) -> TrainState:
    """Step 0 and an EMA copy of exactly the parameters ``optimizer``
    holds (with ``sharding``: of their slices)."""
    if sharding is not None:
        return TrainState(0, model, optimizer,
                          {n: s.detach().clone()
                           for n, s in sharding.shards.items()}, sharding)
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


def reduce_metrics(metrics: dict, group, reduce: str) -> dict:
    """The ranks' metrics over ``group``: means for ``reduce="mean"``
    (``*_sum`` and ``*_cnt`` summed); for ``"sum"`` only ``loss`` (each
    rank's term) is summed, the others being reduced by the loss."""
    W = world_size(group)
    dev = metrics["loss"].device           # nccl reduces on the card only
    keys = [k for k in metrics if reduce == "mean" or k == "loss"]
    vals = [torch.as_tensor(metrics[k], device=dev).detach().float().clone()
            for k in keys]
    all_reduce_(vals, group)
    out = dict(metrics)
    for k, v in zip(keys, vals):
        mean = reduce == "mean" and not k.endswith(("_sum", "_cnt"))
        out[k] = v / W if mean else v
    return out


def make_train_step(loss_fn: Callable, opt: torch.optim.Optimizer,
                    ema_decay: float = 0.9999, grad_accum: int = 1,
                    grad_clip: float = 1.0, group=None,
                    reduce: str | None = None,
                    sharding: ZeroShards | None = None) -> Callable:
    """``loss_fn(batch) -> (loss, metrics)`` on the module the optimizer
    holds. Returns ``train_step(state, batch) -> metrics``, which updates
    ``state`` in place; with ``grad_accum > 1`` the batch's leading axis
    splits into that many micro-batches, gradients are averaged and the
    metrics are the last micro-batch's. The tracer sees the step as
    ``train.step`` (unit: ``state.step``) around ``train.forward`` and
    ``train.backward`` (each micro-batch), ``train.clip``,
    ``train.optimizer`` and ``train.ema``.

    ``reduce`` (``"mean"`` or ``"sum"``) reduces the gradients, the model's
    floating buffers (averaged) and the metrics over ``group`` (None: the
    world's); ``sharding`` runs the update on the ``ZeroShards`` slices
    that ``opt`` holds."""
    if reduce not in (None, "mean", "sum"):
        raise ValueError(f"reduce must be 'mean' or 'sum', got {reduce!r}")

    def train_step(state: TrainState, batch: dict) -> dict:
        with profiling.span("train.step", unit=state.step):
            return step(state, batch)

    def step(state: TrainState, batch: dict) -> dict:
        params = (list(sharding.params.values()) if sharding is not None
                  else [p for g in opt.param_groups for p in g["params"]])
        for p in params:
            p.grad = None
        total = 0.0
        for mb in _micro_batches(batch, grad_accum):
            with profiling.span("train.forward"):
                loss, metrics = loss_fn(mb)
            with profiling.span("train.backward"):
                (loss / grad_accum).backward()
            total = total + loss.detach()
        with profiling.span("train.clip"):
            for p in params:
                if p.grad is None:            # no gradient reached it: zero
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
            if reduce is not None:
                all_reduce_(grads, group)
                if reduce == "mean":
                    torch._foreach_div_(grads, float(world_size(group)))
            norm = global_norm(grads)
            # optax's arithmetic: t / norm * clip above the limit, t below
            # it (t / 1 * 1), without a host sync
            below = norm < grad_clip
            one = torch.ones_like(norm)
            torch._foreach_div_(grads, torch.where(below, one, norm))
            torch._foreach_mul_(grads, torch.where(below, one,
                                                   one * grad_clip))
        with profiling.span("train.optimizer"):
            if sharding is not None:
                sharding.take_grads()
            opt.step()
            if sharding is not None:
                sharding.put_params()
        with profiling.span("train.ema"), torch.no_grad():
            src = (sharding.shards if sharding is not None
                   else dict(state.model.named_parameters()))
            ema = list(state.ema_params.values())
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, [src[n] for n in state.ema_params],
                                alpha=1.0 - ema_decay)
            bufs = [b for b in state.model.buffers()
                    if b.is_floating_point()]
            if reduce == "mean" and bufs:
                all_reduce_(bufs, group)
                torch._foreach_div_(bufs, float(world_size(group)))
        state.step += 1
        metrics = dict(metrics)
        metrics["loss"] = total / grad_accum
        if reduce is not None:
            metrics = reduce_metrics(metrics, group, reduce)
        metrics["grad_norm"] = norm
        return metrics

    return train_step
