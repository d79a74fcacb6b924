"""The port's device rule.

Every entry point takes ``device=None``, which means the CUDA card.  A caller
that wants the CPU asks for it (the CPU tests pass ``device="cpu"``).  If the
card is wanted and there is none, the entry point raises: it never carries on
quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raises if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "microwakeword_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU"
        )
    return dev
