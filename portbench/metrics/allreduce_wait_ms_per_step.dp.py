"""Milliseconds a training step that the ranks spend inside NCCL's
kernels waiting for slower peers: the mean over the ranks of their NCCL
milliseconds a step, less ``allreduce_ms_per_step.dp``'s transfer
(stragglers, garbage collections, uneven host time)."""
from portbench.metrics import _collective


def read(ctx: dict):
    return _collective.wait_ms_per_step(ctx)
