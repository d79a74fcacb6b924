"""``accept_kernel_share`` and ``accept_kernel_us`` on traces built by hand:

- slice 0-100 us; ``accept.counts`` 10-60 holds ``accept.kernel`` 20-30;
- the kernel launched at 22 (in the kernel's span) runs 40-47, a copy
  launched at 50 (in ``accept.counts`` only) runs 50-52, a kernel launched
  at 70 (outside every span) runs 70-90.
"""

from __future__ import annotations

import pytest

from benchmark.lib.cell import module
from benchmark.lib.profile import Trace

OPS = [("accepts_kernel", 40.0, 47.0, 1, "kernel"), ("c2", 50.0, 52.0, 2, "gpu_memcpy"),
       ("k3", 70.0, 90.0, 3, "kernel")]
LAUNCHES = {1: 22.0, 2: 50.0, 3: 70.0}
COUNTS, KERNEL = ("accept.counts", 10.0, 60.0), ("accept.kernel", 20.0, 30.0)


def _trace(annotations, units: int = 1) -> Trace:
    return Trace(wall_s=1e-4, units=units, device_ops=list(OPS), launches=dict(LAUNCHES),
                 annotations=list(annotations), host_ops=[], span=(0.0, 100.0))


def _requests(n: int, kernels: int) -> list:
    """``n`` requests of 100 us, each with an ``accept.counts``, the first
    ``kernels`` of them holding an ``accept.kernel``."""
    out = []
    for i in range(n):
        out.append(("accept.counts", 100.0 * i + 10.0, 100.0 * i + 60.0))
        if i < kernels:
            out.append(("accept.kernel", 100.0 * i + 20.0, 100.0 * i + 30.0))
    return out


@pytest.mark.parametrize("n,kernels,share", [(1, 1, 100.0), (4, 4, 100.0), (4, 1, 25.0)])
def test_accept_kernel_share(n, kernels, share):
    got = module("metrics", "accept_kernel_share").read(_trace(_requests(n, kernels), n))
    assert got == pytest.approx(share)


def test_accept_kernel_share_none_without_kernel_or_counts():
    """No ``accept.kernel`` (the per-frame loop, as before the kernel), or no
    ``accept.counts`` (a slice that counts nothing): nothing to read."""
    read = module("metrics", "accept_kernel_share").read
    assert read(_trace([])) is None
    assert read(_trace([COUNTS])) is None
    assert read(_trace([KERNEL])) is None


@pytest.mark.parametrize("units,us", [(1, 7.0), (2, 3.5)])
def test_accept_kernel_us(units, us):
    """Only the kernel launched inside ``accept.kernel`` counts, wherever it
    runs; the copy launched in ``accept.counts`` and the kernel launched
    outside every span do not.  Per request of the slice."""
    got = module("metrics", "accept_kernel_us").read(_trace([COUNTS, KERNEL], units))
    assert got == pytest.approx(us)


def test_accept_kernel_us_none_without_kernel():
    read = module("metrics", "accept_kernel_us").read
    assert read(_trace([COUNTS])) is None
    assert read(_trace([])) is None
