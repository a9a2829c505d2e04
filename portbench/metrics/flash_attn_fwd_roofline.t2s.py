"""Kernel A's share of its roofline: the sum of ``4 B H T^2 D`` operations
at 989 TFLOP/s or q, k, v, o bytes at 3.35 TB/s, whichever is larger, over
every call the window made (shapes from the benchmark's wrapper of
``ops/attention.py``), over kernel A's device time in the trace, in %."""
from portbench.metrics import _device as _dev


def read(ctx: dict):
    return _dev.roofline(ctx, "flash_attn_fwd", "attn_fwd",
                         _dev.bounds().attn_fwd_bound_s)
