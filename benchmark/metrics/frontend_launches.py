"""The frontend kernel's launches per unit of the traced slice (a train step
or a scoring request), by the program's own counter
``frontend_batch.launches``: 3 while the kernel is three launches.  It
cross-checks the launches that ``frontend_roofline`` finds in the device
trace."""


def read(trace):
    n = trace.counts.get("frontend_launches")
    return n / trace.units if n else None
