"""What several metrics' readers share: a rate over the window, and the
device counts, shares and rooflines of a traced window.  A reader that
finds nothing to read returns None."""

from __future__ import annotations

from frozen.work import bound
from harness import quantile


def rate(ctx):
    """Clips completed in the window over its seconds."""
    return ctx.clips_per_unit * len(ctx.durations) / ctx.window_s


def unit_ms(ctx, q):
    """The ``q`` quantile of the window's units, in ms."""
    return 1e3 * quantile(ctx.durations, q)


def launches(ctx):
    """Kernels launched per unit of the traced window (copies and fills
    left out)."""
    n = sum(k.count for k in ctx.trace.device_keys() if k.activity == "kernel")
    return n / ctx.trace_units if n else None


def idle_pct(ctx):
    """The share of a unit in which no kernel or copy ran: the device's
    busy time per traced unit (the union of its intervals, from the device
    trace) against the mean unit of the run's window (by the host's clock).
    The traced units themselves run ~3x slower than the window's (the
    profiler's cost per launch on the host), so their own window would
    read the host's share too high."""
    if not ctx.busy_s:
        return None
    return 100.0 * (1.0 - (ctx.busy_s / ctx.trace_units) / (ctx.window_s / len(ctx.durations)))


def roofline_pct(ctx, kernel, work, peak):
    """The bound of the traced launches of ``kernel`` (the per-unit list
    ``ctx.work[work]`` of (bytes, flops), each at its bound against ``peak``
    or the bandwidth) over their device time."""
    n, us = ctx.kernel_us(kernel)
    if not n or not ctx.work.get(work):
        return None
    bound_ms = sum(bound(b, f, peak)[0] for b, f in ctx.work[work]) * ctx.trace_units
    return 100.0 * bound_ms * 1e3 / us


def mfu_pct(ctx, peak):
    """The FLOPs the window's units need (counted from shapes) over the
    window at ``peak``, by the host's clock (the traced units, slowed by
    the profiler, are left out)."""
    return 100.0 * ctx.work["flops_per_unit"] * len(ctx.durations) / (ctx.window_s * peak)
