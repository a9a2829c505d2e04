"""Seconds a batch spends in the MV-LDM or GM-LDM sampler's loop (the
``sample`` stage of ``generate_batch``, the ``denoise`` mark of
``GMLDMSystem.sample``)."""
from portbench.metrics import _stage


def read(ctx: dict):
    return _stage.mean_stage_s(ctx, ("sample", "denoise"))
