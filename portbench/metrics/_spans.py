"""Shared by the span readers: the traced window as the port's own tracer
(``prometheus_torch.profiling``) recorded it. Its spans are host clock
readings without a sync: a span's duration is the time the host took to
enqueue its work, unless the host blocked. ``host_syncs`` counts the
implicit device syncs the program made (``torch.cuda``'s sync debug
mode). A program without the tracer, or a window it saw nothing of,
reads None."""


def recording():
    """``(spans, counters)`` of the traced window, or None."""
    try:
        from prometheus_torch import profiling

        spans, counters = profiling.spans(), profiling.counters()
    except (ImportError, AttributeError):
        return None
    return (spans, counters) if spans else None


def named(spans: list, name: str) -> list:
    return [s for s in spans if s["name"] == "prometheus." + name]


def ms(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e6


def mean_ms(name: str) -> float | None:
    """The mean duration of the window's ``prometheus.<name>`` spans."""
    rec = recording()
    got = named(rec[0], name) if rec else []
    return sum(ms(s) for s in got) / len(got) if got else None


def syncs_per_unit(ctx: dict) -> float | None:
    """Implicit host syncs over the window's units."""
    rec = recording()
    if rec is None or not ctx.get("units"):
        return None
    return sum(rec[1]["host_syncs"].values()) / ctx["units"]


def gc_ms_per_unit(ctx: dict) -> float | None:
    """Milliseconds of garbage collection over the window's units."""
    rec = recording()
    if rec is None or not ctx.get("units"):
        return None
    return sum(ms(s) for s in named(rec[0], "gc")) / ctx["units"]
