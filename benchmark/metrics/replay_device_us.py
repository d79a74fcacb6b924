"""What one replayed streamed step costs the card: the device time launched
inside the program's ``stream.replay`` spans (``models/stream_graph.py``,
one graph launch a step; CUPTI credits the graph's kernels to that launch)
over their count, us.  None where the slice has no ``stream.replay`` (a
program that scans eagerly)."""

from benchmark.lib import spans


def read(trace):
    n = spans.count(trace, "stream.replay")
    return 1e3 * spans.device_ms(trace, "stream.replay") / n if n else None
