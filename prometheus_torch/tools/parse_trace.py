"""The top ops of a trace (the counterpart of the repo's
``tools/parse_trace.py``, which reads JAX's ``*.xplane.pb``): this one reads
the Chrome-trace JSON that ``prometheus_torch.profiling.trace`` (and any
``torch.profiler`` export) writes.

Events are grouped as the xplane tool groups them by plane and line: a
"plane" is a device stream (``device <d> stream <s>``: kernels, copies,
sets) or a host thread (``host <pid> thread <tid>``), a "line" is the event
category (``kernel``, ``gpu_memcpy``, ``cpu_op``, ``cuda_runtime``,
``user_annotation`` ...). For each plane and line it prints the ops by
summed duration: ms, share of the line's busy time, count and name; busy
is the sum of the events' durations (nested host ranges count at each
level), span the first start to the last end::

    python -m prometheus_torch.tools.parse_trace TRACE_DIR_OR_JSON \\
        [--top 30] [--plane stream] [--line kernel]

``--gaps`` lists the device's idle gaps instead: the stretches between
the first and the last kernel, copy or set (of any stream) where none
runs, each named by the innermost ``prometheus.*`` span of the tracer
(``prometheus_torch.profiling``) open on the host at the gap's middle
(``prometheus.gc`` among them; ``(no span)`` where none is), and the idle
seconds summed by span.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from collections import defaultdict

# Chrome-trace categories that torch.profiler puts on a device stream
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")


def find_traces(path: str) -> list[str]:
    """``path`` itself if it is a file, else every ``*.json`` below it."""
    if os.path.isfile(path):
        return [path]
    hits = sorted(glob.glob(os.path.join(path, "**", "*.json"),
                            recursive=True))
    if not hits:
        raise FileNotFoundError(f"no *.json trace under {path}")
    return hits


def plane_of(ev: dict) -> str:
    if ev.get("cat") in DEVICE_CATS:
        return f"device {ev.get('pid')} stream {ev.get('tid')}"
    return f"host {ev.get('pid')} thread {ev.get('tid')}"


def summarize(path: str, top: int = 40, plane: str = "",
              line: str = "") -> dict:
    """``{plane: {line: {"events", "busy_ms", "span_ms", "top": [[name,
    ms, count], ...]}}}`` of one Chrome trace, the complete (``"ph": "X"``)
    events only; ``plane`` and ``line`` are case-insensitive substring
    filters."""
    events = _load_events(path)
    agg = defaultdict(lambda: defaultdict(lambda: [0.0, 0]))
    spans = defaultdict(lambda: [float("inf"), float("-inf")])
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        pl, ln = plane_of(ev), str(ev.get("cat", ""))
        if plane and plane.lower() not in pl.lower():
            continue
        if line and line.lower() not in ln.lower():
            continue
        dur, ts = float(ev["dur"]), float(ev.get("ts", 0.0))
        rec = agg[(pl, ln)][ev.get("name", "?")]
        rec[0] += dur
        rec[1] += 1
        span = spans[(pl, ln)]
        span[0], span[1] = min(span[0], ts), max(span[1], ts + dur)
    out: dict = {}
    for (pl, ln), ops in sorted(agg.items()):
        rows = sorted(ops.items(), key=lambda kv: -kv[1][0])
        out.setdefault(pl, {})[ln] = {
            "events": sum(c for _, c in ops.values()),
            "busy_ms": sum(us for us, _ in ops.values()) / 1e3,
            "span_ms": (spans[(pl, ln)][1] - spans[(pl, ln)][0]) / 1e3,
            "top": [[name, us / 1e3, cnt] for name, (us, cnt) in rows[:top]],
        }
    return out


def _load_events(path: str) -> list:
    with open(path) as fp:
        doc = json.load(fp)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def idle_gaps(path: str, top: int = 10) -> dict:
    """``{"busy_ms", "window_ms", "idle_ms", "gaps", "by_span": [[name,
    idle ms, gaps], ...], "longest": [[name, ms], ...]}`` of one Chrome
    trace: the device's busy time (the union of its kernels', copies' and
    sets' intervals), the window from the first of them to the last, and
    the idle gaps inside it by the innermost ``prometheus.*`` span open on
    the host at each gap's middle, largest first (``top`` longest
    gaps)."""
    dev, spans = [], []
    for ev in _load_events(path):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        t0 = float(ev.get("ts", 0.0))
        t1 = t0 + float(ev["dur"])
        if ev.get("cat") in DEVICE_CATS:
            if ev["cat"] != "gpu_user_annotation":
                dev.append((t0, t1))
        elif str(ev.get("name", "")).startswith("prometheus."):
            spans.append((t0, t1, ev["name"]))
    return gaps_by_span(dev, spans, top)


def gaps_by_span(dev: list, spans: list, top: int = 10) -> dict:
    """``idle_gaps`` of device intervals ``dev`` ``[(start, end)]`` and
    host spans ``[(start, end, name)]``, all in us (the tracer's
    in-memory spans, on the profiler's clock, go in as they are, in ns /
    1e3)."""
    out = {"busy_ms": 0.0, "window_ms": 0.0, "idle_ms": 0.0, "gaps": 0,
           "by_span": [], "longest": []}
    if not dev:
        return out
    dev = sorted(dev)
    merged = [list(dev[0])]
    for t0, t1 in dev[1:]:
        if t0 > merged[-1][1]:
            merged.append([t0, t1])
        else:
            merged[-1][1] = max(merged[-1][1], t1)
    # one sweep over the gaps' middles (in order) and the spans by start
    spans = sorted(spans)
    gaps, open_, k = [], [], 0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) / 2
        while k < len(spans) and spans[k][0] <= mid:
            open_.append(spans[k])
            k += 1
        open_ = [sp for sp in open_ if sp[1] >= mid]
        inside = min(open_, key=lambda sp: sp[1] - sp[0], default=None)
        gaps.append((inside[2] if inside else "(no span)", b - a))
    by = defaultdict(lambda: [0.0, 0])
    for name, us in gaps:
        by[name][0] += us
        by[name][1] += 1
    out.update(
        busy_ms=sum(e - s for s, e in merged) / 1e3,
        window_ms=(merged[-1][1] - merged[0][0]) / 1e3,
        idle_ms=sum(us for _, us in gaps) / 1e3, gaps=len(gaps),
        by_span=[[n, us / 1e3, c] for n, (us, c) in
                 sorted(by.items(), key=lambda kv: -kv[1][0])],
        longest=[[n, us / 1e3] for n, us in
                 sorted(gaps, key=lambda g: -g[1])[:top]])
    return out


def print_gaps(g: dict) -> None:
    share = 100 * g["idle_ms"] / g["window_ms"] if g["window_ms"] else 0.0
    print(f"\n== device idle {g['idle_ms']:.3f}ms of {g['window_ms']:.3f}ms "
          f"({share:.2f}%) in {g['gaps']} gaps; busy {g['busy_ms']:.3f}ms ==")
    print(f"{'idle ms':>10} {'%idle':>6} {'gaps':>6}  innermost span")
    for name, ms, cnt in g["by_span"]:
        part = 100 * ms / g["idle_ms"] if g["idle_ms"] else 0.0
        print(f"{ms:10.3f} {part:6.2f} {cnt:6d}  {name}")
    print("longest gaps: " + ", ".join(f"{n} {ms:.3f}ms"
                                       for n, ms in g["longest"]))


def print_summary(summary: dict) -> None:
    for pl, lines in summary.items():
        for ln, s in lines.items():
            print(f"\n== plane '{pl}' line '{ln}' events={s['events']} "
                  f"busy={s['busy_ms']:.3f}ms span={s['span_ms']:.3f}ms ==")
            print(f"{'ms':>10} {'%busy':>6} {'count':>6}  op")
            for name, ms, cnt in s["top"]:
                share = 100 * ms / s["busy_ms"] if s["busy_ms"] else 0.0
                print(f"{ms:10.3f} {share:6.2f} {cnt:6d}  {name[:100]}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace_dir", help="a trace .json or a directory of them")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--plane", default="",
                    help="substring filter on the stream or thread (e.g. "
                         "'device', 'stream 7', 'host')")
    ap.add_argument("--line", default="",
                    help="substring filter on the event category (e.g. "
                         "kernel, cpu_op)")
    ap.add_argument("--gaps", action="store_true",
                    help="the device's idle gaps by the innermost "
                         "prometheus.* span instead")
    args = ap.parse_args(argv)
    out = {}
    for path in find_traces(args.trace_dir):
        print(f"[trace] {path}", file=sys.stderr)
        if args.gaps:
            out[path] = idle_gaps(path, args.top)
            print_gaps(out[path])
        else:
            out[path] = summarize(path, args.top, args.plane, args.line)
            print_summary(out[path])
    return out


if __name__ == "__main__":
    main()
