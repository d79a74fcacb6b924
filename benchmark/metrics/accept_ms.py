"""Accept counting alone (``streaming_eval.ambient_accept_counts`` over one
request's probabilities, counts back on the host): mean milliseconds per
request by CUDA events."""


def read(trace):
    ms = trace.spans.get("accept")
    return sum(ms) / len(ms) if ms else None
