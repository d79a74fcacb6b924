"""What a train step costs the host to enqueue: the program's ``train.step``
spans (one a sub-step) and ``train.report`` (one a call, beside the last
``train.step``) on the host's clock, ms per step of the traced slice."""

from benchmark.lib import spans


def read(trace):
    step = spans.per_unit_host_ms(trace, "train.step")
    return None if step is None else step + spans.host_ms(trace, "train.report") / trace.units
