"""NCCL device milliseconds a data-parallel training step, collective by collective on
the rank that spent the least in it (the last to arrive, who waits
least): close to the gradient all-reduce's transfer itself."""
from portbench.metrics import _collective


def read(ctx: dict):
    return _collective.transfer_ms_per_step(ctx)
