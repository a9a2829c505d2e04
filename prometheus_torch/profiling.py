"""The port's tracer, profiling and step timing on the card
(``prometheus_tpu/profiling.py``).

- ``span(name, unit=..., **attrs)``: a context manager (also a decorator)
  around one piece of the program's work. The tracer is on exactly while
  a ``torch.profiler`` records on the calling thread (``trace`` below,
  the benchmark's ``--trace 1`` window, any ``torch.profiler.profile``);
  off, a span costs one C call and hands back a shared null context that
  records and opens nothing. On, it records ``prometheus.<name>``, its
  start and end in Unix ns, its id, its parent's id (the innermost span
  open on its thread), the id of the unit it ran in and ``attrs``, and it
  is also opened as a ``record_function`` of that name, so that an
  exported trace shows it on the kernels' timeline. ``unit`` starts a
  unit (a step number, or ``True`` for the next number of the tracer's
  own count); the spans inside it inherit its id. Nothing synchronises
  the card: a span's duration is the host's time, which is the time to
  enqueue its kernels unless the host blocked.
- ``stage(name, start_ns, end_ns)``: a span closed after the fact
  (``pipeline.stage_timer``'s marks), ``prometheus.stage.<name>``, with no
  ``record_function``; its parent is the innermost open span that began
  before it, and the spans that closed inside it become its children.
- Counters, kept while the tracer is on: ``host_syncs``, the implicit
  device syncs (``.item()``, ``nonzero``, pageable copies, ...) keyed by
  the innermost open span's name (``""`` outside any), from
  ``torch.cuda.set_sync_debug_mode("warn")``, whose warnings are counted
  and not shown (``torch.cuda.synchronize`` raises none); and a
  ``prometheus.gc`` span for every garbage collection, from
  ``gc.callbacks``, with its generation. The sync mode, the warning hook
  and the GC callback go in at the first span or stage of a recording,
  which also clears the previous recording's spans and counters, and come
  out at the first span, stage or read after it (``trace`` takes them out
  as it ends). And ``graphs``: ``{name: {"captured": n, "replayed": n,
  "eager": n}}`` for each network that can replay a CUDA graph
  (``"traj"``, TrajDiT's trunk, ``models/traj_dit.py``), from
  ``count_graph``: every forward counts once, as ``replayed`` or
  ``eager``, and a forward that captured the graph first also counts as
  ``captured``.
- ``spans()``, ``counters()``, ``reset()``: the recording in memory (at
  most ``MAX_SPANS`` spans; ``counters()["spans_dropped"]`` counts the
  rest).
- ``trace(log_dir)``: ``torch.profiler`` over the enclosed block (CPU and,
  where a card is visible, CUDA activity), written as a Chrome / Perfetto
  trace, ``<log_dir>/trace.json``, with the stage spans added;
- ``StepTimer``: wall-clock step times with EMA smoothing;
  ``measure(sync=...)`` waits for the card that holds ``sync`` before it
  stops the clock, so a step's queued kernels are inside its time;
- ``device_memory_stats()``: bytes in use, the card's size and the peak
  bytes in use, for each visible card (``torch.cuda.memory_stats``).

Spans share the clock of the profiler's events (``start_ns()`` of
``kineto_results``): the host's realtime clock in Unix ns, to which torch
converts its own timestamps.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import itertools
import json
import os
import threading
import time
import warnings

import torch

TRACE_FILE = "trace.json"
PREFIX = "prometheus."
MAX_SPANS = 1 << 18
# the start of the warning torch gives at an implicit sync in "warn" mode
SYNC_WARNING = "called a synchronizing CUDA operation"
GRAPH_EVENTS = ("captured", "replayed", "eager")

enabled = torch._C._autograd._profiler_enabled
now_ns = time.time_ns

_spans: list[dict] = []
_syncs: dict[str, int] = {}
_graphs: dict[str, dict[str, int]] = {}
_dropped = 0
_ids = itertools.count(1)
_units = itertools.count(1)
_local = threading.local()
_nulls: dict = {}
# while the counters' hooks are in: (sync mode to restore, showwarning to
# restore, the filter added)
_hooked = None


def _stack() -> list:
    """This thread's open spans, innermost last."""
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _record(rec: dict) -> None:
    global _dropped
    if len(_spans) < MAX_SPANS:
        _spans.append(rec)
    else:
        _dropped += 1


class _Span:
    """What ``span`` returns while the tracer is off: enters and exits
    doing nothing; as a decorator it opens ``span`` at every call."""

    __slots__ = ("name", "unit", "attrs")

    def __init__(self, name: str, unit, attrs: dict):
        self.name, self.unit, self.attrs = name, unit, attrs

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def __call__(self, fn):
        name, unit, attrs = self.name, self.unit, self.attrs

        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name, unit=unit, **attrs):
                return fn(*args, **kwargs)

        return traced


class _Live(_Span):
    """A span that records: made fresh by each ``span`` call while the
    tracer is on."""

    __slots__ = ("id", "parent", "start", "rf")

    def __enter__(self):
        _hook()
        st = _stack()
        top = st[-1] if st else None
        self.id = next(_ids)
        self.parent = top.id if top else None
        if self.unit is True:
            self.unit = next(_units)
        elif self.unit is None and top is not None:
            self.unit = top.unit
        self.rf = torch.profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        self.start = now_ns()
        st.append(self)
        return self

    def __exit__(self, *exc):
        end = now_ns()
        self.rf.__exit__(*exc)
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:
            st.remove(self)
        _record({"name": PREFIX + self.name, "start_ns": self.start,
                 "end_ns": end, "id": self.id, "parent": self.parent,
                 "unit": self.unit, "tid": threading.get_ident(),
                 "attrs": self.attrs})
        return None


def span(name: str, /, *, unit=None, **attrs):
    """A span named ``prometheus.<name>`` around the ``with`` block (or
    each call of the function it decorates); see the module docstring."""
    if not enabled():
        if _hooked is not None:
            _unhook()
        if unit is None and not attrs:
            null = _nulls.get(name)
            if null is None:
                null = _nulls[name] = _Span(name, None, {})
            return null
        return _Span(name, unit, attrs)
    return _Live(name, unit, attrs)


def stage(name: str, start_ns: int, end_ns: int) -> None:
    """Record ``prometheus.stage.<name>`` from ``start_ns`` to ``end_ns``
    (``now_ns`` readings) where the tracer is on."""
    if not enabled():
        _unhook()
        return
    _hook()
    st = _stack()
    parent = next((s for s in reversed(st) if s.start <= start_ns), None)
    sid, pid = next(_ids), (parent.id if parent is not None else None)
    tid = threading.get_ident()
    for rec in reversed(_spans):       # closed in end order
        if rec["end_ns"] < start_ns:
            break
        if (rec["start_ns"] >= start_ns and rec["parent"] == pid
                and rec["tid"] == tid):
            rec["parent"] = sid
    _record({"name": PREFIX + "stage." + name, "start_ns": start_ns,
             "end_ns": end_ns, "id": sid, "parent": pid,
             "unit": parent.unit if parent is not None else None,
             "tid": tid, "attrs": {}})


def count_graph(name: str, event: str) -> None:
    """Count one ``event`` (``"captured"``, ``"replayed"`` or ``"eager"``)
    of the graphed network ``name`` while the tracer is on."""
    if not enabled():
        if _hooked is not None:
            _unhook()
        return
    _hook()
    per = _graphs.setdefault(name, dict.fromkeys(GRAPH_EVENTS, 0))
    per[event] += 1


def _show_warning(message, category, filename, lineno, file=None,
                  line=None):
    """``warnings.showwarning`` while the hooks are in: a sync warning is
    counted (while the tracer is on) and never shown."""
    if str(message).startswith(SYNC_WARNING):
        if enabled():
            st = _stack()
            key = PREFIX + st[-1].name if st else ""
            _syncs[key] = _syncs.get(key, 0) + 1
        return
    shown = _hooked[1] if _hooked is not None else \
        warnings._showwarning_orig
    shown(message, category, filename, lineno, file, line)


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        if not enabled():
            _local.gc = None
            return
        rf = torch.profiler.record_function(PREFIX + "gc")
        rf.__enter__()
        _local.gc = (rf, now_ns())
        return
    opened = getattr(_local, "gc", None)
    if opened is None:
        return
    _local.gc = None
    end = now_ns()
    rf, start = opened
    rf.__exit__(None, None, None)
    st = _stack()
    top = st[-1] if st else None
    _record({"name": PREFIX + "gc", "start_ns": start, "end_ns": end,
             "id": next(_ids), "parent": top.id if top else None,
             "unit": top.unit if top else None,
             "tid": threading.get_ident(),
             "attrs": {"generation": info["generation"],
                       "collected": info["collected"]}})


def _sync_mode_settable() -> bool:
    """A card is in use in this process (setting the mode would otherwise
    initialise CUDA)."""
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _hook() -> None:
    """A recording starts: clear the last one, put the counters' hooks
    in."""
    global _hooked
    if _hooked is not None:
        return
    reset()
    mode = None
    if _sync_mode_settable():
        mode = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():       # "a prototype feature"
            warnings.simplefilter("ignore")
            torch.cuda.set_sync_debug_mode("warn")
    shown = warnings.showwarning
    warnings.filterwarnings("always", message=SYNC_WARNING)
    added = warnings.filters[0]
    warnings.showwarning = _show_warning
    gc.callbacks.append(_on_gc)
    _hooked = (mode, shown, added)


def _unhook() -> None:
    """The recording has ended: restore what ``_hook`` changed."""
    global _hooked
    if _hooked is None:
        return
    mode, shown, added = _hooked
    _hooked = None
    if mode is not None:
        torch.cuda.set_sync_debug_mode(mode)
    if warnings.showwarning is _show_warning:
        warnings.showwarning = shown
    if added in warnings.filters:      # an "always" filter caches nothing
        warnings.filters.remove(added)
    with contextlib.suppress(ValueError):
        gc.callbacks.remove(_on_gc)


def spans() -> list[dict]:
    """The recording's spans, each a dict: ``name``, ``start_ns``,
    ``end_ns``, ``id``, ``parent``, ``unit``, ``tid``, ``attrs``."""
    if not enabled():
        _unhook()
    return list(_spans)


def counters() -> dict:
    """``{"host_syncs": {span name: count}, "graphs": {network: {event:
    count}}, "spans_dropped": n}``."""
    if not enabled():
        _unhook()
    return {"host_syncs": dict(_syncs),
            "graphs": {k: dict(v) for k, v in _graphs.items()},
            "spans_dropped": _dropped}


def reset() -> None:
    """Forget the recorded spans and counters."""
    global _dropped
    _spans.clear()
    _syncs.clear()
    _graphs.clear()
    _dropped = 0


def _add_stages(path: str, stages: list[dict]) -> None:
    """The stage spans, which have no ``record_function``, into the Chrome
    trace at ``path`` as user annotations of the host thread."""
    with open(path) as fp:
        doc = json.load(fp)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "user_annotation", "name": s["name"], "pid": pid,
         "tid": s["tid"], "ts": (s["start_ns"] - base) / 1e3,
         "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
         "args": {"span": s["id"], "parent": s["parent"], "unit": s["unit"]}}
        for s in stages)
    with open(path, "w") as fp:
        json.dump(doc, fp)


@contextlib.contextmanager
def trace(log_dir: str = "prometheus_trace"):
    """Profile the enclosed block; yields ``log_dir``, where the trace is
    written as ``TRACE_FILE`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    _unhook()
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    stages = [s for s in _spans if s["name"].startswith(PREFIX + "stage.")]
    if stages:
        _add_stages(path, stages)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class StepTimer:
    """Wall-clock step timer with EMA smoothing."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg: float | None = None
        self.last: float | None = None       # the latest step's seconds
        self._t0: float | None = None
        self.steps = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = self.last = time.perf_counter() - self._t0
        self.avg = dt if self.avg is None else \
            self.ema * self.avg + (1 - self.ema) * dt
        self.steps += 1
        return dt

    @contextlib.contextmanager
    def measure(self, sync=None):
        """Time the block; ``sync`` (a tensor, or a list, tuple or dict of
        them) makes the clock stop only once every card holding one of its
        tensors has finished its queued work."""
        self.start()
        yield
        for dev in {t.device for t in _tensors(sync) if t.is_cuda}:
            torch.cuda.synchronize(dev)
        self.stop()


def device_memory_stats() -> list[dict]:
    """One dict per visible card: ``device``, ``bytes_in_use``,
    ``bytes_limit`` (the card's memory) and ``peak_bytes_in_use``, as the
    caching allocator counts them; an empty list without a card."""
    out = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i}",
            "bytes_in_use": s.get("allocated_bytes.all.current"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
        })
    return out
