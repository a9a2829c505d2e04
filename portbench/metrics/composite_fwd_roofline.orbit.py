"""Kernel B's share of its roofline: the (gaussian, pixel) pairs the
window's frames keep, counted by the benchmark's plain projection and
alpha test (an estimate from every eighth frame of the compared videos,
never from the port's worklists), times the fp32 operations of a pair at
67 TFLOP/s, over kernel B's device time, in %."""
from portbench.metrics import _device as _dev


def read(ctx: dict):
    pairs = ctx.get("kept_pairs_per_unit")
    t = _dev.class_s(ctx, "composite_fwd")
    if not pairs or t <= 0:
        return None
    return 100.0 * _dev.bounds().composite_bound_s(pairs * ctx["units"]) / t
