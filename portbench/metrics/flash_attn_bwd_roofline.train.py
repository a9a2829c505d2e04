"""Kernel A-bwd's share of its roofline: the sum of its calls' bounds
(``10 B H T^2 D`` operations, or q, k, v, o, dO and the log-sum-exp read
and dq, dk, dv written) over its device time (the pre-pass, main and
conversion kernels together), in %."""
from portbench.metrics import _device as _dev


def read(ctx: dict):
    return _dev.roofline(ctx, "flash_attn_bwd", "attn_bwd",
                         _dev.bounds().attn_bwd_bound_s)
