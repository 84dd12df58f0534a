"""Reading a ``torch.profiler`` trace: the raw kineto events grouped by
name (a frozen copy of ``chip_smoke.py::profile_keys``, which groups a
step's ~180k events in seconds where ``key_averages`` took minutes), the
union of the device's busy intervals, and the idle gaps between them named
by what the host was doing."""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import torch


# the kineto activities that are the device's own work; its timeline also
# carries annotations (the profiler's steps, ``record_function`` spans) and
# waits, which span work without being any
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


class ProfiledKey:
    """One name's events of one kineto activity type in a profiled run:
    ``count`` and, for the device's work, their summed duration in us
    (``self_device_time_total``, the field of ``key_averages``' rows)."""

    __slots__ = ("key", "activity", "count", "self_device_time_total")

    def __init__(self, key, activity):
        self.key, self.activity = key, activity
        self.count, self.self_device_time_total = 0, 0.0


@dataclass
class Trace:
    """What a profiled window left: ``keys`` (``profile_keys``' groups),
    ``device`` and ``host`` intervals as (start_ns, end_ns, name), sorted."""

    keys: list = field(default_factory=list)
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    def device_keys(self):
        return [k for k in self.keys if k.activity in DEVICE_WORK]


def profile_keys(prof) -> Trace:
    """The raw profiler events of ``prof`` grouped by name and activity
    type, without building ``key_averages``' per-event objects; with the
    interval of every event of the device's work and of the host kept (the
    device's annotations and waits are counted and not kept)."""
    return group_events(prof.profiler.kineto_results.events())


def activity_type(e, cuda) -> str:
    """Kineto's activity type of event ``e``.  Torch before 2.12 gives no
    ``activity_type``; there a device event is an annotation where
    ``is_user_annotation`` says so, a copy or a fill by kineto's name for
    it, and a kernel otherwise."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if e.device_type() != cuda:
        return "user_annotation" if e.is_user_annotation() else "cpu_op"
    if e.is_user_annotation():
        return "gpu_user_annotation"
    name = e.name()
    return "gpu_memcpy" if name.startswith("Memcpy") else \
        "gpu_memset" if name.startswith("Memset") else "kernel"


def group_events(events) -> Trace:
    """``profile_keys`` over kineto events (``name``, ``device_type``,
    ``activity_type`` or ``is_user_annotation``, ``start_ns``,
    ``end_ns``)."""
    cuda = torch.autograd.DeviceType.CUDA
    keys, names = {}, {}
    trace = Trace()
    for e in events:
        raw, activity = e.name(), activity_type(e, cuda)
        k = keys.get((raw, activity))
        if k is None:
            if raw not in names:
                names[raw] = torch._C._demangle(raw)
            k = keys[(raw, activity)] = ProfiledKey(names[raw], activity)
        k.count += 1
        span = (e.start_ns(), e.end_ns(), k.key)
        if activity in DEVICE_WORK:
            k.self_device_time_total += (e.end_ns() - e.start_ns()) / 1e3
            trace.device.append(span)
        elif e.device_type() != cuda:
            trace.host.append(span)
    trace.keys = list(keys.values())
    trace.device.sort()
    trace.host.sort()
    return trace


def busy_intervals(spans):
    """The union of (start, end, _) spans as sorted disjoint (start, end)."""
    merged = []
    for start, end, _ in spans:
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return merged


def idle_gaps(trace: Trace, merged, top: int = 10, longest: int = 2000):
    """The ``longest`` idle gaps between the device's busy intervals, their
    seconds summed by the innermost host event that spans each gap's
    midpoint ("python" where no recorded host event does), largest first:
    [[name, seconds], ...]."""
    starts = [s for s, _, _ in trace.host]
    gaps = sorted(((b - a, a, b) for (_, a), (b, _) in zip(merged, merged[1:])),
                  reverse=True)[:longest]
    by_name = {}
    for length, a, b in gaps:
        mid = (a + b) // 2
        name, best = "python", None
        # of the host events that started shortly before the midpoint, the
        # shortest one still running at it is the innermost
        i = bisect.bisect_right(starts, mid)
        for s, e, n in trace.host[max(0, i - 64):i]:
            if e >= mid and (best is None or e - s < best):
                name, best = n, e - s
        by_name[name] = by_name.get(name, 0.0) + length / 1e9
    return sorted(([n, t] for n, t in by_name.items()), key=lambda x: -x[1])[:top]
