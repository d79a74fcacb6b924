"""Kernels launched per train step in the traced slice (the step's
sampler, forward, backward, Adam and metrics together)."""


def read(trace):
    kernels = trace.kernels()
    return len(kernels) / trace.units if kernels else None
