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
    with open(path) as fp:
        doc = json.load(fp)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
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
    args = ap.parse_args(argv)
    out = {}
    for path in find_traces(args.trace_dir):
        print(f"[trace] {path}", file=sys.stderr)
        out[path] = summarize(path, args.top, args.plane, args.line)
        print_summary(out[path])
    return out


if __name__ == "__main__":
    main()
