"""Device busy milliseconds a training step: the union of the kernels',
copies' and sets' intervals in the window's trace over the steps
completed. Steadier than the step's host time; its gap to
``train_step_s`` is the host's share."""


def read(ctx: dict):
    tr = ctx.get("trace") or {}
    if not tr.get("busy_s") or not ctx.get("work"):
        return None
    return 1e3 * tr["busy_s"] / ctx["work"]
