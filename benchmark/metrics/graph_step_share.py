"""The share of streamed steps that replay a CUDA graph: the program's
``stream.replay`` spans over its ``stream.step`` spans
(``ModelBundle.stream_scan``), in %.  None where the slice has no
``stream.replay`` (a program that scans eagerly) or no ``stream.step``."""

from benchmark.lib import spans


def read(trace):
    steps, replays = spans.count(trace, "stream.step"), spans.count(trace, "stream.replay")
    return 100.0 * replays / steps if steps and replays else None
