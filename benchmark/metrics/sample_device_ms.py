"""The device time of the train step's batch draw: operations launched
inside the program's ``train.sample`` spans (``sample_any``: windows,
gather, the frontend kernel for raw audio, SpecAugment), ms per step of the
traced slice."""

from benchmark.lib import spans


def read(trace):
    return spans.per_unit_device_ms(trace, "train.sample")
