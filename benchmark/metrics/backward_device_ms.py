"""The device time of the train step's backward: operations launched inside
the program's ``train.backward`` spans (``torch.autograd.grad``, the flat
gradient, a mesh's all-reduce), ms per step of the traced slice."""

from benchmark.lib import spans


def read(trace):
    return spans.per_unit_device_ms(trace, "train.backward")
