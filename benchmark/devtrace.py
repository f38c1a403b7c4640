"""Reading the device trace of a traced run (`torch.profiler`, CUPTI).

`read(prof)` returns the device's operations [(name, start_us, end_us)]:
kernels, copies and sets, in microseconds of the wall clock, the clock
of the benchmark's host spans (`harness.Spans.wall`, nanoseconds).
`summary` reduces them over the window (the "window" span): the union of
their intervals (the device's busy time), device seconds by kernel group
and by name, and the idle gaps between them, each labelled by the host
span that was open on the dispatching thread during it.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List

from benchmark.peaks import group


DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def read(prof) -> List:
    """Device operations of the profile; on torch builds whose events carry
    no activity type, every CUDA event that is not a user annotation."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != cuda:
            continue
        kind = getattr(evt, "activity_type", None)
        if kind is not None and kind() not in DEVICE_ACTIVITIES:
            continue
        note = getattr(evt, "is_user_annotation", None)
        if note is not None and note():
            continue
        if hasattr(evt, "start_ns"):
            start, dur = evt.start_ns() / 1e3, evt.duration_ns() / 1e3
        else:
            start, dur = evt.start_us(), evt.duration_us()
        out.append((evt.name(), start, start + dur))
    out.sort(key=lambda k: k[1])
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summary(kernels, spans) -> Dict:
    """Busy and window seconds, device seconds by group and by kernel, and
    the idle gaps (label, seconds) of the traced window."""
    spans = [(n, t, s / 1e3, e / 1e3) for n, t, s, e in spans]
    win = [s for s in spans if s[0] == "window"]
    if not win:
        raise ValueError("no window span")
    w0, w1, main = win[0][2], win[0][3], win[0][1]
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in kernels
              if e > w0 and s < w1]
    merged = _union([(s, e) for _, s, e in inside])
    busy_us = sum(e - s for s, e in merged)
    by_group = collections.Counter()
    by_kernel = collections.Counter()
    for n, s, e in inside:
        by_group[group(n)] += (e - s) / 1e6
        by_kernel[n] += (e - s) / 1e6
    # the dispatching thread's spans do not nest: the one open at a time
    host = sorted((s, e, n) for n, t, s, e in spans
                  if t == main and n != "window")
    starts = [h[0] for h in host]
    gaps = []
    prev = w0
    for s, e in merged + [[w1, w1]]:
        if s > prev:
            mid = (prev + s) / 2
            i = bisect.bisect_right(starts, mid) - 1
            label = host[i][2] if i >= 0 and host[i][1] >= mid else "none"
            gaps.append((label, (s - prev) / 1e6))
        prev = max(prev, e)
    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "by_group": dict(by_group), "by_kernel": dict(by_kernel),
            "gaps": gaps, "inside": len(inside),
            "first_us": (inside[0][1] - w0) if inside else float("nan")}


def breakdown(summ: Dict) -> Dict:
    ops = sorted(summ["by_group"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summ["gaps"], key=lambda g: -g[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


def kernel_seconds(summ: Dict, substrings) -> float:
    return sum(s for n, s in summ["by_kernel"].items()
               if any(k in n for k in substrings))
