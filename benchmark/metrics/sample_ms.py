"""The sampler alone (``sampler.sample_any`` with the cell's arguments and a
generator of its own): mean milliseconds per batch by CUDA events."""


def read(trace):
    ms = trace.spans.get("sample")
    return sum(ms) / len(ms) if ms else None
