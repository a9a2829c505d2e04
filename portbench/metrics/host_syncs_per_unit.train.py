"""Implicit device syncs the program makes a unit (``.item()``,
``nonzero``, pageable copies: the tracer's ``host_syncs`` counter over
the window's units; the stage timer's and the harness's own
``torch.cuda.synchronize`` are not among them)."""
from portbench.metrics import _spans


def read(ctx: dict):
    return _spans.syncs_per_unit(ctx)
