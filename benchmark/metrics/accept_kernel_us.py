"""What the counting kernel costs the card: the device time launched inside
the program's ``accept.kernel`` spans (``evaluate/accepts_kernel.py``) per
request, us.  None where the slice has no ``accept.kernel`` (a program that
counts in the per-frame loop)."""

from benchmark.lib import spans


def read(trace):
    ms = spans.per_unit_device_ms(trace, "accept.kernel")
    return None if ms is None else 1e3 * ms
