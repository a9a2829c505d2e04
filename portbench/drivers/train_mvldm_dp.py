"""Stage-2 training data-parallel over the ranks of a group
(``portbench/ranks.py``, one rank a card): ``train_mvldm``'s step on each
rank, each with its own pool of batches from the seed and its rank (rank
0's is the one-card cell's), the trainer built as ``train.py`` builds it
under ``torchrun`` (``train.build_parallel``'s ``Parallel``), so that the
program's own ``reduce="mean"`` path reduces the gradients and the
floating buffers. The global batch of a step is the ranks' batches in
rank order; its draws are the trainer's, global, each rank taking its
rows.

The float32 reference follows the global batch's first three steps from
the same weights, batches and generator states: each rank runs its own
rows of the global batch, and the shards' gradients and losses are summed
with a plain ``torch.distributed.all_reduce`` of float32 (float64 for the
loss) tensors; then clip, AdamW and the EMA run on every rank alike. The
numbers are ``train_mvldm``'s, ``loss`` (compared here: its control
reads above three times the program's most) and ``ranks``: the largest
relative gap of any rank's parameter norms from rank 0's once the window
has closed (every rank applies the same reduced gradient: 0).

In a process alone (no group) it is ``train_mvldm``'s driver, with
``ranks`` 0.
"""
from __future__ import annotations

import types
from pathlib import Path

import torch
import torch.distributed as dist

from portbench import manifest as mf

base = mf.driver("train_mvldm", Path(__file__).resolve().parents[1])

NUMBERS = ("loss",) + base.NUMBERS + ("ranks",)
FOLLOWED = base.FOLLOWED


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


class Driver(base.Driver):
    numbers_compared = NUMBERS

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.rank = dist.get_rank() if _grouped() else 0
        self.world = dist.get_world_size() if _grouped() else 1
        self.rank_gap = 0.0
        super().__init__(cfg, mix, seed, device)

    def parallel(self):
        if not _grouped():
            return None
        from prometheus_torch import train

        args = types.SimpleNamespace(
            sp_views=False, param_sharding="replicated", stage="mvldm",
            joint_sv=True, render_loss=False)
        return train.build_parallel(args, None, self.device.type)[0]

    def end_to_end(self, units: int, work: int, window_s: float) -> dict:
        return {"dp_train_step_s": window_s / work}

    # -- the reference over the shards ------------------------------------
    def followed_batch(self, i: int) -> dict:
        if self.world == 1:
            return super().followed_batch(i)
        if not hasattr(self, "_global"):
            n = min(FOLLOWED, self.mix["pool"])
            pools = [self.make_pool(r, n) for r in range(self.world)]
            self._global = [{k: torch.cat([p[j][k] for p in pools])
                             for k in pools[0][0]} for j in range(n)]
        return self._global[i % len(self._global)]

    def own_rows(self, B: int) -> range:
        n = B // self.world
        return range(self.rank * n, (self.rank + 1) * n,
                     self.mix["reference_rows"])

    def reduce_reference(self, total: float, grads: dict) -> float:
        if self.world == 1:
            return total
        t = torch.tensor([total], dtype=torch.float64, device=self.device)
        dist.all_reduce(t)
        for g in grads.values():
            dist.all_reduce(g)
        return float(t)

    def layer_context(self) -> dict:
        return dict(super().layer_context(), world=self.world,
                    reduced_bytes=self.reduced_bytes())

    def reduced_bytes(self) -> float:
        """The bytes a step's reduction carries, counted on the plain
        reference on the meta device: the trained U-Net's float32
        gradients and the model's floating buffers (none)."""
        from portbench import bounds
        from portbench.reference import mv_ldm

        with torch.device("meta"):
            model = mv_ldm.MVLDMModel(**dict(self.cfg["mvldm"],
                                             use_checkpoint=False))
        leaves = [p for n, p in model.named_parameters()
                  if n.startswith("unet.")]
        leaves += [b for b in model.buffers() if b.is_floating_point()]
        return bounds.reduced_bytes((t.numel(), t.element_size())
                                    for t in leaves)

    # -- every rank's parameters after the window -------------------------
    def release(self):
        if self.world > 1 and self.trainer is not None:
            trained = self._trained()
            norms = torch.stack([torch.linalg.vector_norm(
                trained[n].detach().double()) for n in sorted(trained)])
            every = [torch.empty_like(norms) for _ in range(self.world)]
            dist.all_gather(every, norms)
            ref = every[0].clamp_min(1e-30)
            self.rank_gap = max(float(((e - every[0]).abs() / ref).max())
                                for e in every)
        super().release()

    def numbers(self, control: bool = False) -> dict:
        out = super().numbers(control)
        out["ranks"] = 0.0 if control else self.rank_gap
        return out
