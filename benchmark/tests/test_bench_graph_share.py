"""``graph_step_share`` on traces built by hand: the share of ``stream.step``
spans that hold a ``stream.replay``."""

from __future__ import annotations

import pytest

from benchmark.lib.cell import module
from benchmark.lib.profile import Trace


def _trace(annotations) -> Trace:
    return Trace(wall_s=1e-4, units=1, device_ops=[], launches={},
                 annotations=list(annotations), host_ops=[], span=(0.0, 100.0))


def _steps(n: int, replayed: int) -> list:
    """``stream.scan`` 0-100 holding ``n`` steps of 10 us, the first
    ``replayed`` of them with a replay inside."""
    out = [("stream.scan", 0.0, 100.0)]
    for i in range(n):
        out.append(("stream.step", 10.0 * i, 10.0 * i + 9.0))
        if i < replayed:
            out.append(("stream.replay", 10.0 * i + 2.0, 10.0 * i + 7.0))
    return out


@pytest.mark.parametrize("n,replayed,share", [(8, 8, 100.0), (8, 4, 50.0), (3, 1, 100 / 3)])
def test_graph_step_share(n, replayed, share):
    got = module("metrics", "graph_step_share").read(_trace(_steps(n, replayed)))
    assert got == pytest.approx(share)


def test_graph_step_share_none_without_steps_or_replays():
    """No ``stream.step`` (no scan in the slice), or no ``stream.replay`` (a
    program that scans eagerly, as before the graph): nothing to read."""
    read = module("metrics", "graph_step_share").read
    assert read(_trace([])) is None
    assert read(_trace([("stream.scan", 0.0, 50.0), ("stream.capture", 1.0, 40.0)])) is None
    assert read(_trace(_steps(8, 0))) is None
