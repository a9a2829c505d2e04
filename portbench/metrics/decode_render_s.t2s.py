"""Seconds a batch spends after the sampler: the GS decoder (or the
GM-LDM's VAE decode), ``convert_gaussians`` and the render."""
from portbench.metrics import _stage


def read(ctx: dict):
    return _stage.mean_stage_s(
        ctx, ("decode_gaussians", "render", "decode", "convert"))
