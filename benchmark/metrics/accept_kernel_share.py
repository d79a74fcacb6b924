"""The share of accept countings that run the counting kernel: the
program's ``accept.kernel`` spans (one launch of ``csrc/accepts.cu`` in
``roc.count_accepts``) over its ``accept.counts`` spans
(``ambient_accept_counts``), in %.  None where the slice has no
``accept.kernel`` (a program that counts in the per-frame loop) or no
``accept.counts``."""

from benchmark.lib import spans


def read(trace):
    calls, kernels = spans.count(trace, "accept.counts"), spans.count(trace, "accept.kernel")
    return 100.0 * kernels / calls if calls and kernels else None
