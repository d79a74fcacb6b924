"""Accept counting inside the scoring request: the program's
``accept.counts`` span (``ambient_accept_counts``: moving average, cooldown
counts, the counts brought to the host) on the host's clock, ms per
request."""

from benchmark.lib import spans


def read(trace):
    return spans.per_unit_host_ms(trace, "accept.counts")
