"""Kernels launched per request in the traced slice (copy in, frontend,
streamed steps, copy out): the same count as ``kernels_per_step``."""

from benchmark.metrics.kernels_per_step import read  # noqa: F401
