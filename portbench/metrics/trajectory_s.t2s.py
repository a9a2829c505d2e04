"""Seconds a batch spends in TrajDiT's DDIM trajectory (the pipeline's
``trajectory`` stage)."""
from portbench.metrics import _stage


def read(ctx: dict):
    return _stage.mean_stage_s(ctx, ("trajectory",))
