"""What one streamed step costs the host: the mean duration of the
program's ``stream.step`` spans (one ``model.step`` call of
``ModelBundle.stream_scan``), us."""

from benchmark.lib import spans


def read(trace):
    n = spans.count(trace, "stream.step")
    return 1e3 * spans.host_ms(trace, "stream.step") / n if n else None
