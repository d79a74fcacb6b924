"""The program's own spans in a traced slice.

The port opens a ``record_function`` range at each layer boundary while a
profiler records (``microwakeword_tpu_torch/trace.py`` lists the names);
``lib/profile.py`` keeps them with the traffic's own ranges in
``Trace.annotations``, on the clock of the device operations.  A device
operation belongs to a span when the host call that launched it (found in
``Trace.launches`` by correlation) lies inside one of the span's ranges, as
in ``Trace.kernels(within=...)``.  Ranges of one name that overlap count once
where time is divided (``device_ms``, ``idle_share``).

A program without a span of that name gives ``count`` 0: the metric readers
then return None.
"""

from __future__ import annotations

import bisect


def ranges(trace, name: str) -> list:
    """(start us, end us) of every range named ``name``, by start."""
    return sorted((s, e) for n, s, e in trace.annotations if n == name)


def _merged(trace, name: str) -> list:
    merged = []
    for s, e in ranges(trace, name):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def count(trace, name: str) -> int:
    return len(ranges(trace, name))


def host_ms(trace, name: str) -> float:
    """The summed durations of the ranges named ``name``, ms."""
    return sum(e - s for s, e in ranges(trace, name)) / 1e3


def device_ms(trace, name: str) -> float:
    """The summed durations of device operations (kernels, copies, memsets)
    launched inside a range named ``name``, ms."""
    merged = _merged(trace, name)
    starts = [s for s, _ in merged]

    def inside(corr) -> bool:
        t = trace.launches.get(corr)
        if t is None:
            return False
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= merged[i][1]

    return sum(e - s for _, s, e, corr, _ in trace.device_ops if inside(corr)) / 1e3


def idle_share(trace, name: str) -> float | None:
    """The share of the slice's idle time (its time between the device's busy
    intervals) that lies inside ranges named ``name``; None for a slice that
    is never idle."""
    lo, hi = trace.span
    edges = [lo] + [x for iv in trace.busy() for x in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    inside, merged, j = 0.0, _merged(trace, name), 0
    for a, b in gaps:  # both sorted and disjoint: one pass
        while j < len(merged) and merged[j][1] <= a:
            j += 1
        k = j
        while k < len(merged) and merged[k][0] < b:
            inside += min(b, merged[k][1]) - max(a, merged[k][0])
            k += 1
    return inside / idle


def per_unit_host_ms(trace, name: str) -> float | None:
    """``host_ms`` over the slice's units (steps or requests); None where the
    program has no span ``name``."""
    return host_ms(trace, name) / trace.units if count(trace, name) else None


def per_unit_device_ms(trace, name: str) -> float | None:
    """``device_ms`` over the slice's units; None where the program has no
    span ``name``."""
    return device_ms(trace, name) / trace.units if count(trace, name) else None
