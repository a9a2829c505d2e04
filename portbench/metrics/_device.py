"""Shared by the device readers: the profiler's reduction of the window
(``portbench/trace.py``) and the peaks and kernel bounds
(``portbench/bounds.py``)."""
from portbench import bounds as _bounds


def bounds():
    return _bounds


def idle_share(ctx: dict):
    tr = ctx.get("trace") or {}
    if not tr.get("busy_s") or not ctx.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / ctx["window_s"])


def class_s(ctx: dict, cls: str) -> float:
    return (ctx.get("trace") or {}).get("classes", {}).get(cls, 0.0)


def roofline(ctx: dict, cls: str, shapes_key: str, bound_fn):
    """Sum of the kernel's bounds over the calls the window made, over its
    device time, in %; None where it did not run."""
    t = class_s(ctx, cls)
    shapes = ctx.get(shapes_key) or []
    if t <= 0 or not shapes:
        return None
    return 100.0 * sum(bound_fn(s) for s in shapes) / t


def mfu(ctx: dict, peak: float):
    """Model FLOPs of the window's units over the window, in % of the
    peak."""
    flops = ctx.get("flops_per_unit")
    if not flops or not ctx.get("window_s"):
        return None
    return 100.0 * flops * ctx["units"] / ctx["window_s"] / peak
