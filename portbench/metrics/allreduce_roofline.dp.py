"""The gradient reduction's share of its roofline: the least time an
all-reduce of a step's bytes can take on these cards (every trained
leaf's float32 gradient and every floating buffer the step reduces,
counted on the plain reference: each card takes in the sum and sends its
own part out at least once, at NVLink 4's 450 GB/s each way), over the
step's NCCL transfer time (``allreduce_ms_per_step.dp``), in %. A ring
moves ``2 (W - 1) / W`` of the bytes each way and reads at most 67% on
four cards; NVLink SHARP (NVLS), which reduces in the switch, moves
``(W + 1) / W`` and reads at most 80%."""
from portbench.metrics import _collective
from portbench.metrics import _device as _dev


def read(ctx: dict):
    got = _collective.split_s(ctx)
    if (got is None or not ctx.get("work") or not ctx.get("reduced_bytes")
            or ctx.get("world", 1) < 2):
        return None
    bound = _dev.bounds().allreduce_bound_s(ctx["reduced_bytes"])
    return 100.0 * bound * ctx["work"] / got[0]
