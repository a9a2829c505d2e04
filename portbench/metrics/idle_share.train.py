"""Share of the measured window in which no kernel, copy or set ran on
the device (``torch.profiler``'s trace of the window), in %."""
from portbench.metrics import _device as _dev


def read(ctx: dict):
    return _dev.idle_share(ctx)
