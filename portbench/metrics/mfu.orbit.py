"""The whole video's share of the card's fp32 peak (67 TFLOP/s): the fp32
operations of the pairs the window's frames keep (as in
``composite_fwd_roofline.orbit``) over the window, in %. It bounds kernel
B's roofline share from the whole video's side: projection, binning and
the host copies are in its time."""
from portbench.metrics import _device as _dev


def read(ctx: dict):
    pairs = ctx.get("kept_pairs_per_unit")
    if not pairs or not ctx.get("window_s"):
        return None
    b = _dev.bounds()
    ops = pairs * ctx["units"] * b.COMPOSITE_OPS_PER_PAIR
    return 100.0 * ops / ctx["window_s"] / b.PEAK_FP32_FLOPS
