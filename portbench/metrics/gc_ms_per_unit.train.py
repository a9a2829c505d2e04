"""Milliseconds of Python garbage collection a unit (the tracer's
``prometheus.gc`` spans over the window's units): host time in which
nothing is enqueued."""
from portbench.metrics import _spans


def read(ctx: dict):
    return _spans.gc_ms_per_unit(ctx)
