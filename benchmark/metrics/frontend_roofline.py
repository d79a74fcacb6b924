"""The frontend kernel's share of its roofline, in %: the least time of its
calls on this card (``benchmark.counts.frontend.bound_s``: the larger of its
FP32 operations over the FP32 peak and its bytes over the memory rate) over
the device time of its three launches in the traced slice."""

from benchmark.counts import frontend


def read(trace):
    c = trace.counts
    if "frontend_batch" not in c:
        return None
    ops = [k for k in trace.kernels() if any(name in k[0] for name in frontend.KERNELS)]
    device_s = sum(e - s for _, s, e, _, _ in ops) / 1e6
    if device_s <= 0:
        return None
    bound, _ = frontend.bound_s(c["frontend_batch"], c["frontend_samples"], c["frontend_step_ms"])
    return 100.0 * bound * c["frontend_calls"] / device_s
