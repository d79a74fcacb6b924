"""Cooldown accept counting as one CUDA kernel (``csrc/accepts.cu``).

``count_accepts`` has the signature and the result of ``roc.count_accepts``
for a CUDA tensor: probabilities [..., T] (cast to float32, as the loop
casts them) -> int64 counts [..., len(cutoffs)], bit for bit the loop's.
It launches one kernel on the current stream: one block per track, one
thread per cutoff, each thread walking the frames with its cooldown in a
register.  The cutoffs travel in the launch's parameters, so nothing waits
for the card before or after the launch.  ``count_accepts.launches`` counts
the launches.  Under a torch profiler each launch is an ``accept.kernel``
span (``trace.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from microwakeword_tpu_torch import _build
from microwakeword_tpu_torch.trace import span

_INT32 = 2**31
_INVALID_VALUE = 1  # cudaErrorInvalidValue


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("accepts")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mww_accepts_error_string.argtypes = [i32]
    lib.mww_accepts_error_string.restype = ctypes.c_char_p
    lib.mww_accepts_count.argtypes = [ptr, i32, i32, ptr, i32, i32, ptr, ptr]
    lib.mww_accepts_count.restype = i32
    return lib


def count_accepts(probs: torch.Tensor, cutoffs, ignore_slices_after_accept: int) -> torch.Tensor:
    """[..., T] probabilities on a CUDA device -> int64 counts
    [..., len(cutoffs)] (``roc.count_accepts``'s semantics, which checks
    that the cutoffs are one axis).  Raises on another device, a tensor
    without a time axis, more than 512 cutoffs (the kernel's block), or a
    cooldown outside int32."""
    if probs.device.type != "cuda":
        raise ValueError(f"no accept-counting kernel for device {probs.device}")
    if probs.dim() == 0:
        raise ValueError("probs must have a time axis")
    cut = np.ascontiguousarray(cutoffs, np.float32).reshape(-1)
    reset = int(ignore_slices_after_accept)
    if not -_INT32 < reset < _INT32:
        raise ValueError(f"ignore_slices_after_accept {reset} is outside int32")
    lead, t = probs.shape[:-1], probs.shape[-1]
    rows = math.prod(lead)
    if rows >= _INT32 or t >= _INT32:
        raise ValueError(f"probs shape {tuple(probs.shape)} exceeds the kernel's limits")
    counts = torch.empty((rows, cut.size), dtype=torch.int64, device=probs.device)
    if rows == 0 or cut.size == 0:
        return counts.reshape(lead + (cut.size,))
    tracks = probs.to(torch.float32).reshape(rows, t).contiguous()
    lib = _library()
    with span("accept.kernel"), torch.cuda.device(probs.device):
        err = lib.mww_accepts_count(
            tracks.data_ptr(), rows, t, cut.ctypes.data, cut.size, reset, counts.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err == _INVALID_VALUE:
        raise ValueError(f"the kernel takes at most 512 cutoffs, got {cut.size}")
    if err != 0:
        msg = lib.mww_accepts_error_string(err).decode()
        raise RuntimeError(f"accept-counting kernel failed: cudaError {err} ({msg})")
    count_accepts.launches += 1
    return counts.reshape(lead + (cut.size,))


count_accepts.launches = 0
