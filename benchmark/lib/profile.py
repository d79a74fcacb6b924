"""A short profiled slice of the timed path, read from torch.profiler's trace.

``profile(fn, units)`` runs ``fn`` once under the profiler (CPU and CUDA
activities), exports the Chrome trace to a temporary file in ``TMPDIR``,
reads it back and deletes it.  What the per-layer readers use:

- device operations (kernels, copies, memsets) with their intervals on the
  trace's clock, the union of which is the device's busy time;
- kernel launches: each host runtime call's time by its correlation id, so
  that a kernel belongs to the annotated host range that launched it;
- ``record_function`` ranges that the traffic driver put around its calls;
- host operators, to name what the host was doing in each idle gap.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile
import time

SLICE = "bench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    wall_s: float  # host clock over the slice, ending in a synchronize
    units: int  # steps or requests in the slice
    device_ops: list  # (name, start us, end us, correlation, category)
    launches: dict  # correlation -> host us of the runtime call
    annotations: list  # (name, start us, end us)
    host_ops: list  # (name, start us, end us), sorted by start
    span: tuple  # (start us, end us) of the slice on the trace's clock
    spans: dict = dataclasses.field(default_factory=dict)  # name -> [ms], from the driver
    counts: dict = dataclasses.field(default_factory=dict)  # name -> value, from the driver

    def kernels(self, within: str | None = None) -> list:
        """Kernels (not copies or memsets), or those launched inside the
        annotated host ranges named ``within``."""
        ks = [k for k in self.device_ops if k[4] == "kernel"]
        if within is None:
            return ks
        ranges = sorted((a[1], a[2]) for a in self.annotations if a[0] == within)
        starts = [r[0] for r in ranges]

        def inside(corr):
            t = self.launches.get(corr)
            if t is None:
                return False
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t <= ranges[i][1]

        return [k for k in ks if inside(k[3])]

    def busy(self) -> list:
        """Merged intervals (us) in which a device operation ran, clipped to the slice."""
        lo, hi = self.span
        merged = []
        for _, s, e, _, _ in sorted(self.device_ops, key=lambda k: k[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations with the most time and the idle time by the
        innermost host operator running in each gap, seconds, ``top`` each."""
        by_op = collections.Counter()
        for name, s, e, _, _ in self.device_ops:
            by_op[name[:120]] += (e - s) / 1e6
        busy = self.busy()
        lo, hi = self.span
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        starts = [op[1] for op in self.host_ops]
        by_host = collections.Counter()
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid, name = (a + b) / 2, "Python between operators"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 5000, -1), -1):
                if self.host_ops[j][2] >= mid:
                    name = self.host_ops[j][0][:120]
                    break
            by_host[name] += (b - a) / 1e6
        return {"device_ops": [[n, s] for n, s in by_op.most_common(top)],
                "idle_gaps": [[n, s] for n, s in by_host.most_common(top)]}


def _read(path: str, wall_s: float, units: int) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device_ops, launches, annotations, host_ops = [], {}, [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, ts, dur = ev.get("cat", ""), float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            device_ops.append((ev.get("name", ""), ts, ts + dur, args.get("correlation"), cat))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = ts
        elif cat == "user_annotation":
            annotations.append((ev.get("name", ""), ts, ts + dur))
        elif cat == "cpu_op":
            host_ops.append((ev.get("name", ""), ts, ts + dur))
    host_ops.sort(key=lambda op: op[1])
    slices = [a for a in annotations if a[0] == SLICE]
    span = (slices[0][1], slices[0][2]) if slices else (0.0, wall_s * 1e6)
    return Trace(wall_s, units, device_ops, launches, annotations, host_ops, span)


def profile(fn, units: int, sync) -> Trace:
    """``fn()`` once under the profiler; ``sync()`` waits for the device."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SLICE):
            t0 = time.perf_counter()
            fn()
            sync()
            wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return _read(path, wall, units)
    finally:
        os.unlink(path)
