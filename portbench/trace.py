"""Reduce a ``torch.profiler`` run over the measured window to the device's
busy time, its kernels by name and class, and the longest idle gaps.

The kernel classes are those of ``chip_smoke.py::kernel_class`` and the
busy / idle arithmetic that of ``chip_smoke.py::profile_run`` and
``tools/parse_trace.py`` (commit 078c4a5), frozen: user annotations are
left out, as there; one change: busy time is the union of the device
intervals, so overlapping streams count once. One class added: an NCCL
kernel (a collective between cards) is ``collective``, and the durations
of those kernels are kept in launch order, so that the readers can set
the same collective on every rank side by side.
"""
from __future__ import annotations

import numpy as np

CLASSES = (("collective", ("nccl",)),
           ("flash_attn_fwd", ("flash_fwd",)),
           ("flash_attn_bwd", ("flash_bwd",)),
           ("composite_fwd", ("composite_fwd",)),
           ("composite_bwd", ("composite_bwd",)),
           ("layout", ("nchwtonhwc", "nhwctonchw")),
           ("convolution", ("conv", "implicit", "winograd")),
           ("matmul", ("gemm", "xmma", "cutlass", "sm90", "nvjet")),
           ("sort", ("sort", "radix")),
           ("reduction", ("reduce", "norm", "softmax")),
           ("elementwise", ("elementwise", "vectorized", "unrolled", "copy",
                            "cat", "multi_tensor_apply")))


def kernel_class(name: str) -> str:
    n = name.lower()
    for cls, keys in CLASSES:
        if any(k in n for k in keys):
            return cls
    return "other"


def _events(prof):
    """``(device, host)`` lists of ``(start_ns, end_ns, name)``."""
    import torch

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        # a user annotation on the device's timeline (the optimizer's
        # ``Optimizer.step#AdamW.step``) spans kernels counted on their own
        note = getattr(e, "is_user_annotation", None)
        if note is not None and note():
            continue
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        rec = (t0, t1, e.name())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(rec)
        else:
            host.append(rec)
    return dev, host


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged intervals of sorted ``starts``: ``(m_starts, m_ends)``."""
    ms, me = [], []
    cur_s, cur_e = starts[0], ends[0]
    for s, e in zip(starts[1:], ends[1:]):
        if s > cur_e:
            ms.append(cur_s)
            me.append(cur_e)
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    ms.append(cur_s)
    me.append(cur_e)
    return np.array(ms), np.array(me)


def summarize(prof, window_s: float) -> dict:
    """``busy_s`` (device time with something running), ``kernels``
    ``{name: seconds}``, ``classes`` ``{class: seconds}``, ``collectives``
    (each NCCL kernel's seconds, in the order of their starts),
    ``device_ops`` and ``idle_gaps`` (the 10 largest each, ``[name,
    seconds]``; a gap is named after the innermost host operation that
    spans its middle). A run over several cards reduces each rank's own
    trace (``merge_ranks``)."""
    dev, host = _events(prof)
    kernels: dict = {}
    for t0, t1, name in dev:
        kernels[name] = kernels.get(name, 0.0) + (t1 - t0) * 1e-9
    classes: dict = {}
    for name, s in kernels.items():
        c = kernel_class(name)
        classes[c] = classes.get(c, 0.0) + s
    out = {"busy_s": 0.0, "window_s": window_s, "kernels": kernels,
           "classes": classes, "launches": len(dev), "device_ops": [],
           "idle_gaps": [],
           "collectives": [(t1 - t0) * 1e-9 for t0, t1, name in sorted(dev)
                           if kernel_class(name) == "collective"]}
    if not dev:
        return out
    arr = np.array([(a, b) for a, b, _ in dev], dtype=np.int64)
    arr = arr[np.argsort(arr[:, 0], kind="stable")]
    ms, me = _union(arr[:, 0], arr[:, 1])
    out["busy_s"] = float((me - ms).sum()) * 1e-9
    out["device_ops"] = [[n, s] for n, s in sorted(
        kernels.items(), key=lambda kv: -kv[1])[:10]]
    gaps_s, gaps_e = me[:-1], ms[1:]
    order = np.argsort(gaps_s - gaps_e)[:10]
    if host:
        h = np.array([(a, b) for a, b, _ in host], dtype=np.int64)
        names = [n for _, _, n in host]
    for i in order:
        g0, g1 = int(gaps_s[i]), int(gaps_e[i])
        label = "host"
        if host:
            mid = (g0 + g1) // 2
            inside = np.nonzero((h[:, 0] <= mid) & (h[:, 1] >= mid))[0]
            if inside.size:
                j = inside[np.argmin(h[inside, 1] - h[inside, 0])]
                label = names[j]
        out["idle_gaps"].append([label, (g1 - g0) * 1e-9])
    return out


def merge_ranks(summaries: list) -> dict:
    """One card's view of a run over several, from each rank's own
    ``summarize``: rank 0's summary (its kernels, classes, device ops and
    gaps) with ``busy_s`` the mean over the ranks."""
    busy = sum(s.get("busy_s", 0.0) for s in summaries) / len(summaries)
    return dict(summaries[0], busy_s=busy)
