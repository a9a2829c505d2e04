"""Share of the window's device time in kernels other than kernel B:
projection, csort binning, gathers and the copies to the host, in %."""
from portbench.metrics import _device as _dev


def read(ctx: dict):
    tr = ctx.get("trace") or {}
    busy = sum(tr.get("classes", {}).values())
    if busy <= 0:
        return None
    return 100.0 * (busy - _dev.class_s(ctx, "composite_fwd")) / busy
