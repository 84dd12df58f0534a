"""The general part of the benchmark: it finds a cell's files by name, runs
the closed loop for the window, traces a few units of work, reduces the
metrics and prints the result line.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own under this directory, found by the name that
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the sizes the program is built with
  (``model``), its dtype, the plain reference beside it
  (``reference/<reference>.py``) and the limits of the comparison;
* ``traffic/<traffic>.json``: the parameters of one mix and the driver
  that runs it (``drivers/<driver>.py``);
* ``work/<config>.py``: the operations and bytes a roofline or an MFU
  divides by;
* ``metrics/<metric>.py``: one reader per metric, ``read(ctx)``, which
  returns a number or None (nothing to read: the metric is left out).

A driver has ``setup()`` (build the program from weights drawn on the
device, warm up every shape of the mix), ``unit(i)`` (one pass or step,
waited for), ``check()`` (after the window: the reference's comparison,
[(name, value, limit)]) and ``clips_per_unit``, ``attempted``, ``failed``.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that the timed process may not hold: JAX and the
# JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "ipoke_tpu")
# a traced run profiles TRACE_WARM units it discards, then TRACE_UNITS
TRACE_WARM, TRACE_UNITS = 1, 3


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under this directory, as a module (of the
    package ``<kind>`` where it is one, as ``reference`` is)."""
    if (BENCH / kind / "__init__.py").exists():
        return importlib.import_module(f"{kind}.{name}")
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h100_bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


@dataclass
class Cell:
    """One entry of ``workloads`` with its files read."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def find_cell(workload: str, bench: dict | None = None) -> Cell:
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    w = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    mine = lambda m: workload in m.get("workloads", [workload])
    return Cell(workload, w["chips"], w["config"], load_json("configs", w["config"]),
                load_json("traffic", w["traffic"]),
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


@dataclass
class Ctx:
    """What a metric's reader reads: the window (``durations`` of its units
    in s, its length ``window_s``; a traced run has its window too, before
    the traced units), and in a traced run the ``trace`` of ``trace_units``
    units over ``trace_window_s``, with ``busy_s`` the union of the
    device's intervals in it; ``work`` from ``work/<config>.py``."""

    cell: Cell
    clips_per_unit: int
    durations: list = field(default_factory=list)
    window_s: float = 0.0
    trace: object = None
    trace_units: int = 0
    trace_window_s: float = 0.0
    busy_s: float = 0.0
    work: dict = field(default_factory=dict)

    def kernel_us(self, key: str):
        """(launches, device us) of the traced kernels whose name holds
        ``key``."""
        ks = [k for k in self.trace.device_keys() if key in k.key]
        return sum(k.count for k in ks), sum(k.self_device_time_total for k in ks)


def quantile(values, q: float) -> float:
    """The ``q`` quantile of ``values`` by linear interpolation between
    order statistics (``statistics.quantiles``' inclusive method)."""
    return statistics.quantiles(values, n=100, method="inclusive")[round(100 * q) - 1]


def window(driver, seconds: float):
    """Run units until ``seconds`` have passed: (durations, window_s)."""
    durations = []
    t0 = time.perf_counter()
    i = 0
    while True:
        s = time.perf_counter()
        driver.unit(i)
        e = time.perf_counter()
        durations.append(e - s)
        i += 1
        if e - t0 >= seconds:
            return durations, e - t0


def traced(driver, start: int):
    """``TRACE_WARM`` then ``TRACE_UNITS`` units under ``torch.profiler``,
    recording the device alone (recording every host operation too made a
    sampling pass ~4x slower on an H100's host), the first units discarded:
    (trace, window_s of the kept units); then one more unit with the host's
    operations recorded, whose trace names the device's idle gaps."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from frozen.trace import profile_keys

    sched = schedule(wait=0, warmup=TRACE_WARM, active=TRACE_UNITS, repeat=1)
    device_only = [ProfilerActivity.CUDA if driver.device.type == "cuda"
                   else ProfilerActivity.CPU]
    with profile(activities=device_only, schedule=sched) as prof:
        for i in range(TRACE_WARM):
            driver.unit(start + i)
            prof.step()
        t0 = time.perf_counter()
        for i in range(TRACE_UNITS):
            driver.unit(start + TRACE_WARM + i)
            prof.step()
        window_s = time.perf_counter() - t0
    trace = profile_keys(prof)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as host:
        driver.unit(start + TRACE_WARM + TRACE_UNITS)
    return trace, window_s, profile_keys(host)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def pin_to_one_core():
    """Keep this process, and every thread it starts, on one core (the last
    it may use): the loop is paced by the host, and a run that the
    scheduler moves between the machine's shared cores reads their speeds
    in turn."""
    core = {max(os.sched_getaffinity(0))}
    for tid in os.listdir("/proc/self/task"):
        os.sched_setaffinity(int(tid), core)


def setup_torch():
    """Settings of every run: fp32 products in fp32 (TF32 off, as the port's
    CLI sets them), one host thread for torch's CPU ops."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    return torch


def make_driver(cell: Cell, seed: int, device, control=None):
    return load_module("drivers", cell.traffic["driver"]).Driver(cell, seed, device, control)


def run(argv, t_start: float, cell: Cell | None = None, device=None) -> int:
    """One run of one cell; prints the result as the last line of stdout.
    ``cell`` and ``device`` replace the workload's files and the look for
    CUDA devices (the tests drive a run on the CPU so, at a small size)."""
    args = parse(argv)
    cell = cell or find_cell(args.workload)
    if device is None:
        pin_to_one_core()
    torch = setup_torch()
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"needs {cell.chips} CUDA device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    driver = make_driver(cell, args.seed, device)
    driver.setup()
    # what set-up made lives for the whole run: the collector need not scan it
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    ctx = Ctx(cell, driver.clips_per_unit)
    ctx.durations, ctx.window_s = window(driver, args.seconds)
    if args.trace:
        ctx.trace, ctx.trace_window_s, host_trace = traced(driver, len(ctx.durations))
        ctx.trace_units = TRACE_UNITS
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    checks = driver.check()
    correct = driver.failed == 0 and all(v <= lim for _, v, lim in checks)

    result_device = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips,
                     "memory_peak_bytes": peak}
    breakdown = None
    if args.trace:
        from frozen.trace import busy_intervals, idle_gaps

        merged = busy_intervals(ctx.trace.device)
        ctx.busy_s = sum(e - s for s, e in merged) / 1e9
        result_device.update(busy_s=ctx.busy_s, window_s=ctx.trace_window_s)
        ops = sorted(ctx.trace.device_keys(), key=lambda k: -k.self_device_time_total)
        breakdown = {"device_ops": [[k.key[:200], k.self_device_time_total / 1e6]
                                    for k in ops[:10]],
                     "idle_gaps": [[n[:200], t] for n, t in idle_gaps(
                         host_trace, busy_intervals(host_trace.device))]}
    ctx.work = load_module("work", cell.config_name).counts(cell.config, cell.traffic)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = setup_s if m["name"] == "setup_s" else \
            load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    found = forbidden_modules()
    if found:
        print(f"the timed process holds {', '.join(found)}", file=sys.stderr)
        return 3
    build_s = driver.build_s
    print("units (ms): " + " ".join(f"{1e3 * d:.1f}" for d in ctx.durations),
          file=sys.stderr)
    print(f"{cell.name}: seed {args.seed}, {len(ctx.durations)} units in "
          f"{ctx.window_s:.3f} s, set-up {setup_s:.3f} s (kernel build "
          f"{'none, cached' if build_s is None else f'{build_s:.3f} s'}), peak "
          f"{peak} bytes on {kind}; reference check {driver.check_s:.3f} s",
          file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    result = {"correct": correct, "attempted": driver.attempted, "failed": driver.failed,
              "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # a number that is not finite (a pass that overflowed) goes out as null
    result["checks"] = {name: {"value": value if math.isfinite(value) else None, "limit": limit}
                        for name, value, limit in checks}
    print(json.dumps(result))
    return 0
