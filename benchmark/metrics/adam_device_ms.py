"""The device time of the train step's Adam: operations launched inside the
program's ``train.adam`` spans (Adam on the flat parameter vector), ms per
step of the traced slice."""

from benchmark.lib import spans


def read(trace):
    return spans.per_unit_device_ms(trace, "train.adam")
