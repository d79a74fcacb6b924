"""The readers of the program's spans (``benchmark/lib/spans.py``) and the
per-layer metrics over them, on a trace built by hand:

- slice 0-100 us; ``stream.scan`` 0-60 holds ``stream.step`` 10-40;
- a kernel launched at 5 (in the scan) runs 5-30, a copy launched at 15 (in
  the step) runs 30-45, a kernel launched at 70 (outside every span) runs
  70-100;
- so the device idles 0-5 and 45-70, 20 of its 30 us inside the scan.
"""

from __future__ import annotations

import pytest

from benchmark.lib import spans
from benchmark.lib.cell import module
from benchmark.lib.profile import Trace

OPS = [("k1", 5.0, 30.0, 1, "kernel"), ("c2", 30.0, 45.0, 2, "gpu_memcpy"),
       ("k3", 70.0, 100.0, 3, "kernel")]
LAUNCHES = {1: 5.0, 2: 15.0, 3: 70.0}
ANNOTATIONS = [("stream.scan", 0.0, 60.0), ("stream.step", 10.0, 40.0)]
FAMILIES = ["step_host_ms", "sample_device_ms", "forward_device_ms", "backward_device_ms",
            "adam_device_ms", "report_device_ms", "scan_step_host_us", "accept_host_ms",
            "scan_idle_share", "copy_out_ms"]


def _trace(annotations=ANNOTATIONS, units: int = 1) -> Trace:
    return Trace(wall_s=1e-4, units=units, device_ops=list(OPS), launches=dict(LAUNCHES),
                 annotations=list(annotations), host_ops=[], span=(0.0, 100.0))


def test_host_ms_and_count():
    tr = _trace()
    assert spans.host_ms(tr, "stream.scan") == pytest.approx(0.060)
    assert spans.host_ms(tr, "stream.step") == pytest.approx(0.030)
    assert spans.count(tr, "stream.scan") == spans.count(tr, "stream.step") == 1
    assert spans.count(tr, "accept.counts") == 0 and spans.host_ms(tr, "accept.counts") == 0


def test_device_ms_by_launch():
    """Each operation counts where its launch lies, whenever it runs; the one
    launched outside every span counts nowhere."""
    tr = _trace()
    assert spans.device_ms(tr, "stream.scan") == pytest.approx(0.040)
    assert spans.device_ms(tr, "stream.step") == pytest.approx(0.015)
    assert spans.device_ms(tr, "accept.counts") == 0


def test_idle_share():
    tr = _trace()
    assert spans.idle_share(tr, "stream.scan") == pytest.approx(20 / 30)
    assert spans.idle_share(tr, "stream.step") == 0
    assert spans.idle_share(tr, "accept.counts") == 0


def test_metrics_read_the_spans():
    tr = _trace()
    assert module("metrics", "scan_step_host_us").read(tr) == pytest.approx(30.0)
    assert module("metrics", "scan_idle_share").read(tr) == pytest.approx(100 * 20 / 30)
    two = _trace([("train.step", 0.0, 20.0), ("train.sample", 1.0, 10.0),
                  ("train.step", 20.0, 50.0), ("train.backward", 12.0, 45.0),
                  ("train.report", 60.0, 80.0)], units=2)
    assert module("metrics", "step_host_ms").read(two) == pytest.approx(0.070 / 2)
    assert module("metrics", "sample_device_ms").read(two) == pytest.approx(0.025 / 2)
    assert module("metrics", "backward_device_ms").read(two) == pytest.approx(0.015 / 2)
    assert module("metrics", "report_device_ms").read(two) == pytest.approx(0.030 / 2)


@pytest.mark.parametrize("family", FAMILIES)
def test_metric_is_none_without_its_span(family):
    assert module("metrics", family).read(_trace([])) is None
