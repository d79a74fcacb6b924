"""The device time of the train step's report: operations launched inside
the program's ``train.report`` spans (``binary_metrics`` and the loss, once
per call), ms per step of the traced slice."""

from benchmark.lib import spans


def read(trace):
    return spans.per_unit_device_ms(trace, "train.report")
