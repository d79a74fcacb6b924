"""The whole step's or request's share of the card's FP32 peak, in %: the
model FLOPs of all the window's work (``benchmark.counts.<family>``, counted
from the configuration's shapes; 3x the forward's for a train step) over the
seconds the traffic driver gives that work (``mfu_s``: the window's seconds
on the host's clock for a serving cell, the card's seconds of the window's
gated steps for a train cell, as its end-to-end metric takes them) and the
peak."""

from benchmark.counts.peaks import PEAK_FP32_FLOPS


def read(trace):
    c = trace.counts
    if not c.get("mfu_s") or not c.get("mfu_flops"):
        return None
    return 100.0 * c["mfu_flops"] / c["mfu_s"] / PEAK_FP32_FLOPS
