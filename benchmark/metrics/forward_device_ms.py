"""The device time of the train step's forward: operations launched inside
the program's ``train.forward`` spans (class weights, keep mask, the
train-mode forward, weighted BCE), ms per step of the traced slice."""

from benchmark.lib import spans


def read(trace):
    return spans.per_unit_device_ms(trace, "train.forward")
