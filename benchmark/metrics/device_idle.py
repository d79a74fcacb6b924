"""Share of the traced slice's wall time in which no operation ran on the
device: one minus the union of device operations' intervals over the slice,
in %."""


def read(trace):
    if trace.window_s() <= 0 or not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s())
