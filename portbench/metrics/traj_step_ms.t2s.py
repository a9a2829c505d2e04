"""Milliseconds the host takes for one of TrajDiT's DDIM steps (the mean
``prometheus.traj.step`` span): its enqueue time, which is its pace, the
steps being host-bound."""
from portbench.metrics import _spans


def read(ctx: dict):
    return _spans.mean_ms("traj.step")
