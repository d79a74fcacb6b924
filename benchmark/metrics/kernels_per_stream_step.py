"""Kernels launched by ``stream_scan`` per streamed step: those whose launch
lies inside the driver's ``bench.stream_scan`` range, over its steps."""


def read(trace):
    kernels = trace.kernels(within="bench.stream_scan")
    steps = trace.counts.get("stream_steps")
    return len(kernels) / steps if kernels and steps else None
