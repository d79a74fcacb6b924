"""The share of the traced slice's device idle time that lies inside the
program's ``stream.scan`` spans, in %: how much of the card's waiting the
streamed steps' host work accounts for."""

from benchmark.lib import spans


def read(trace):
    if not spans.count(trace, "stream.scan"):
        return None
    share = spans.idle_share(trace, "stream.scan")
    return None if share is None else 100.0 * share
