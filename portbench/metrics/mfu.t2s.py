"""The whole batch's share of the card's bf16 peak (989 TFLOP/s): the
model FLOPs of the window's batches, counted once on the plain reference
at the batch's shapes (``FlopCounterMode``, attention included), over the
window, in %."""
from portbench.metrics import _device as _dev


def read(ctx: dict):
    return _dev.mfu(ctx, _dev.bounds().PEAK_BF16_FLOPS)
