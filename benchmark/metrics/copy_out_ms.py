"""The probabilities' way back to the host in ``predict_clip``: the
program's ``predict.copy_out`` span, which waits for the card to finish the
request's queued kernels and then copies, ms per request."""

from benchmark.lib import spans


def read(trace):
    return spans.per_unit_host_ms(trace, "predict.copy_out")
