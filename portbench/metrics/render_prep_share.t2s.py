"""Share of the render stage, in %, that the host spends projecting the
views and binning them before the compositor (``prometheus.render.
project`` and ``prometheus.render.bin`` spans inside the
``prometheus.stage.render`` span, which ends at the stage's sync)."""
from portbench.metrics import _spans


def read(ctx: dict):
    rec = _spans.recording()
    if rec is None:
        return None
    stages = _spans.named(rec[0], "stage.render")
    total = sum(_spans.ms(s) for s in stages)
    if not total:
        return None
    prep = sum(_spans.ms(p)
               for name in ("render.project", "render.bin")
               for p in _spans.named(rec[0], name)
               if any(s["start_ns"] <= p["start_ns"] <= s["end_ns"]
                      for s in stages))
    return 100.0 * prep / total
