"""Shared by the stage readers: the mean seconds a unit spent in the named
stages of the port's own stage timings (``pipeline.stage_timer``: a host
clock after ``torch.cuda.synchronize`` at each stage's end)."""


def mean_stage_s(ctx: dict, stages: tuple) -> float | None:
    rows = [t for t in ctx.get("timings", []) if any(s in t for s in stages)]
    if not rows:
        return None
    return sum(sum(t.get(s, 0.0) for s in stages) for t in rows) / len(rows)
