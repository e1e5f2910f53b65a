"""Reduce a ``torch.profiler`` trace of whole images or steps to what the
per-layer readers and the result's ``breakdown`` read.

Busy time is the union of the device's intervals (kernels, memsets,
copies), not the sum of their self times, so overlapping operations count
once. The traced window is the harness's own ``rtbench.traced`` span. An
idle gap is named after the innermost host operation running at its
middle, or the harness span (``rtbench.framebuffer``, ``rtbench.post``,
``rtbench.step``) whose Python it falls in: what the host was doing
while the device waited.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict
from typing import List, Optional, Tuple

WINDOW_SPAN = "rtbench.traced"
TOP = 10

Interval = Tuple[str, float, float]  # (name, start µs, end µs)


@dataclasses.dataclass
class Trace:
    """What the per-layer readers read (``rtbench/metrics/*.py``)."""

    kind: str  # "image" or "train"
    units: int  # whole images or steps traced
    device_events: List[Interval]
    busy_s: float
    window_s: float
    post_ms: List[float]  # host clock, every image of the run (image cells)
    scene_s: float  # host clock around the scene's load


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces,
    template arguments and parameters."""
    bare = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", bare, maxsplit=1)[0].strip() or name


def _union(intervals: List[Interval], lo: float, hi: float):
    """Merged [start, end] spans of ``intervals`` clipped to [lo, hi]."""
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in intervals if e > lo and s < hi)
    merged: List[List[float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_label(cpu_starts, cpu: List[Interval], spans: List[Interval], t: float) -> str:
    """The innermost host operation running at ``t``, else the harness
    span it falls in (the host in Python between operations)."""
    i = bisect.bisect_right(cpu_starts, t)
    for j in range(i - 1, max(-1, i - 257), -1):
        name, s, e = cpu[j]
        if e >= t:
            return name
    for name, s, e in spans:
        if s <= t <= e:
            return f"python in {name}"
    return "python"


def reduce(prof) -> Optional[dict]:
    """→ {"device_events", "busy_s", "window_s", "breakdown"} of a stopped
    profiler, or None when it saw no device operation or no window."""
    from torch.autograd import DeviceType

    device, cpu, spans, window = [], [], [], None
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            # A span's mirror on the device's timeline is no device work.
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith("rtbench.")):
                device.append(span)
        elif e.name == WINDOW_SPAN:
            window = span
        elif e.name.startswith("rtbench."):
            spans.append(span)
        else:
            cpu.append(span)
    if not device or window is None:
        return None
    lo, hi = window[1], window[2]
    merged = _union(device, lo, hi)
    busy_us = sum(e - s for s, e in merged)
    cpu.sort(key=lambda x: x[1])
    starts = [s for _, s, _ in cpu]
    gaps = defaultdict(float)
    edge = lo
    for s, e in merged + [[hi, hi]]:
        if s > edge:
            gaps[_host_label(starts, cpu, spans, 0.5 * (edge + s))] += (s - edge) * 1e-6
        edge = max(edge, e)
    ops = defaultdict(float)
    for name, s, e in device:
        ops[short_name(name)] += (e - s) * 1e-6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(device_events=[d for d in device if d[2] > lo and d[1] < hi],
                busy_s=busy_us * 1e-6, window_s=(hi - lo) * 1e-6,
                breakdown=dict(device_ops=[[n, v] for n, v in top],
                               idle_gaps=[[n, v] for n, v in idle]))
