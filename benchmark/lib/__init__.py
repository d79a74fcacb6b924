"""Shared parts of the benchmark harness: cells, the card, inputs from the
seed, the profiler's trace and the comparisons that decide ``correct``."""
