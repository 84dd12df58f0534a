"""The metric arithmetic on fixed inputs, and the frozen work formulas
against the bounds the port's chip runs were read against (K1 26.3 us at M
2560, K1 144, Hid 2048, N 288; K2 10.0 us at B 40, 8x8, C 32)."""

import statistics

import pytest
import torch

import harness
import readers
from frozen.trace import ProfiledKey, Trace, busy_intervals, group_events, idle_gaps
from frozen.work import BF16_FLOPS, FP32_FLOPS, bound, nice_work, unit_work

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class OldEvent:
    """A kineto event as ``group_events`` reads one from torch before 2.12,
    which gives no activity type."""

    def __init__(self, name, device, activity, start, end):
        self._v = name, device, activity, start, end

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def is_user_annotation(self):
        return "annotation" in self._v[2]

    def start_ns(self):
        return self._v[3]

    def end_ns(self):
        return self._v[4]


class Event(OldEvent):
    """A kineto event as torch 2.12 on gives it."""

    def activity_type(self):
        return self._v[2]


def ctx(durations, **kw):
    c = harness.Ctx(cell=None, clips_per_unit=100, durations=durations,
                    window_s=sum(durations))
    for k, v in kw.items():
        setattr(c, k, v)
    return c


def test_rate_takes_all_work_over_all_time():
    c = ctx([0.5] * 10)
    c.window_s = 5.2  # the loop's own time between units counts too
    assert readers.rate(c) == pytest.approx(1000 / 5.2)


def test_p90_of_all_units():
    d = [i / 1000 for i in range(1, 101)]
    assert readers.unit_ms(ctx(d), 0.9) == pytest.approx(90.1)
    assert readers.unit_ms(ctx(d), 0.9) == pytest.approx(
        1e3 * statistics.quantiles(d, n=10, method="inclusive")[8])


def test_busy_union_and_idle_share():
    spans = [(0, 100_000_000, "a"), (50_000_000, 200_000_000, "b"),
             (300_000_000, 400_000_000, "c")]
    merged = busy_intervals(spans)
    assert merged == [[0, 200_000_000], [300_000_000, 400_000_000]]
    c = ctx([0.5] * 4, busy_s=0.3, trace_units=1)
    assert readers.idle_pct(c) == pytest.approx(40.0)
    host = Trace(host=[(0, 400_000_000, "outer"), (210_000_000, 290_000_000, "aten::mm")])
    assert idle_gaps(host, merged) == [["aten::mm", pytest.approx(0.1)]]


def test_roofline_and_mfu():
    k1 = nice_work(2560, 144, 2048, 288)
    key = ProfiledKey("void nice_net_stage<2>(...)", "kernel")
    key.count, key.self_device_time_total = 6, 2 * 2 * bound(*k1, BF16_FLOPS)[0] * 1e3
    c = ctx([1.0], busy_s=1.0, trace_units=2, trace=Trace(keys=[key]),
            work={"k1": [k1], "flops_per_unit": 0.5 * BF16_FLOPS})
    assert readers.roofline_pct(c, "nice_net_stage", "k1", BF16_FLOPS) == pytest.approx(50.0)
    assert readers.roofline_pct(c, "macow_unit_inverse", "k2", FP32_FLOPS) is None
    assert readers.mfu_pct(c, BF16_FLOPS) == pytest.approx(50.0)
    assert readers.launches(c) == 3


def test_frozen_work_reproduces_the_recorded_bounds():
    ms, by = bound(*nice_work(2560, 144, 2048, 288), BF16_FLOPS)
    assert (round(ms * 1e3, 1), by) == (26.3, "operations")
    ms, by = bound(*unit_work(40, 8, 32, 128), FP32_FLOPS)
    assert (round(ms * 1e3, 1), by) == (10.0, "operations")


@pytest.mark.parametrize("event", [Event, OldEvent])
def test_spans_on_the_device_timeline_are_no_device_work(event):
    """A ``record_function`` span, and the profiler's own step, land on the
    device's timeline as annotations that cover the work: neither counts
    as busy time or as a launch."""
    events = [event(*e) for e in [
        ("ProfilerStep#1", CUDA, "gpu_user_annotation", 0, 1_000_000),
        ("decode", CUDA, "gpu_user_annotation", 100_000, 900_000),
        ("decode", CPU, "user_annotation", 50_000, 800_000),
        ("cudaLaunchKernel", CPU, "cuda_runtime", 60_000, 70_000),
        ("conv_kernel", CUDA, "kernel", 100_000, 300_000),
        ("conv_kernel", CUDA, "kernel", 400_000, 500_000),
        ("Memcpy HtoD", CUDA, "gpu_memcpy", 600_000, 650_000),
    ]]
    trace = group_events(events)
    assert busy_intervals(trace.device) == [[100_000, 300_000], [400_000, 500_000],
                                           [600_000, 650_000]]
    assert {k.key: k.count for k in trace.device_keys()} == {"conv_kernel": 2,
                                                             "Memcpy HtoD": 1}
    c = ctx([1.0], trace=trace, trace_units=1)
    assert readers.launches(c) == 2
    # the host's span stays a host span: it names the idle gaps it covers
    assert [n for _, _, n in trace.host] == ["decode", "cudaLaunchKernel"]
