"""The whole step's share of the card's bf16 peak (989 TFLOP/s): the model
FLOPs of a step (the frozen VAE encoder's forward, the U-Net's forward and
backward on the multi-view and the single-view batch, no recomputation),
counted once on the plain reference at the step's shapes, times the
window's steps, over the window, in %."""
from portbench.metrics import _device as _dev


def read(ctx: dict):
    return _dev.mfu(ctx, _dev.bounds().PEAK_BF16_FLOPS)
