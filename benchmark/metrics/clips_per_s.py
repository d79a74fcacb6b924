"""Clips per second of the window on the host's clock: steps x batch over
the time from the window's start to the ``torch.cuda.synchronize`` after its
last step, as ``train()`` would see it."""


def read(trace):
    return trace.counts.get("clips_per_s") or None
