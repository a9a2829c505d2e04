"""Milliseconds the host takes for one training step (the mean
``prometheus.train.step`` span: enqueue time, no sync inside). Beside
``device_ms_per_step.train`` and ``train_step_s`` it says which side sets
the pace."""
from portbench.metrics import _spans


def read(ctx: dict):
    return _spans.mean_ms("train.step")
