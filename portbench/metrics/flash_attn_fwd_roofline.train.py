"""Kernel A's share of its roofline in the training step (forward and
the checkpointed blocks' recomputation): the sum of its calls' bounds
(``4 B H T^2 D`` operations or the q, k, v, o bytes) over its device time,
in %."""
from portbench.metrics import _device as _dev


def read(ctx: dict):
    return _dev.roofline(ctx, "flash_attn_fwd", "attn_fwd",
                         _dev.bounds().attn_fwd_bound_s)
