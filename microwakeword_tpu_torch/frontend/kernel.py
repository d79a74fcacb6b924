"""The micro-frontend's CUDA kernel (``csrc/frontend.cu``) and its wrapper.

``frontend_batch`` has the signature of the TPU kernel's wrapper
(``microwakeword_tpu/frontend/pallas.py:frontend_batch``): [B, N] int16 or
float PCM, ``step_ms`` 10 or 20 -> [B, T, 40] float32 features.  A CUDA
tensor launches the kernel (two launches: A, the filterbank; B, the EMA and
AGC) or raises; a CPU tensor takes the plain version in ``frontend/plain.py``.
``frontend_batch.launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from microwakeword_tpu_torch import _build
from microwakeword_tpu_torch.frontend import constants as C
from microwakeword_tpu_torch.frontend import plain

_MAX_BATCH = 65535  # launch A puts the batch on grid dimension y


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("frontend")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mww_frontend_error_string.argtypes = [i32]
    lib.mww_frontend_error_string.restype = ctypes.c_char_p
    lib.mww_frontend_filterbank.argtypes = [
        ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr
    ]
    lib.mww_frontend_filterbank.restype = i32
    lib.mww_frontend_agc.argtypes = [ptr, ptr, i32, i32, ptr]
    lib.mww_frontend_agc.restype = i32
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.mww_frontend_error_string(err).decode()
        raise RuntimeError(f"frontend kernel {what} failed: cudaError {err} ({msg})")


def frontend_batch(audio: torch.Tensor, step_ms: int = 10) -> torch.Tensor:
    """[B, N] int16/float32 samples -> [B, T, 40] float32 features in [0, 26].

    T = 1 + (N - 480) // hop, and 0 when N < 480 (no launch then).
    """
    if not isinstance(audio, torch.Tensor):
        raise TypeError(f"audio must be a torch.Tensor, got {type(audio).__name__}")
    if audio.device.type == "cpu":
        return plain.frontend_batch(audio, step_ms)
    if audio.device.type != "cuda":
        raise ValueError(f"no frontend kernel for device {audio.device}")
    hop = C.hop_samples(step_ms)
    if audio.dim() != 2:
        raise ValueError(f"audio must be [B, N], got shape {tuple(audio.shape)}")
    if audio.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"audio must be int16 or float32 on CUDA, got {audio.dtype}")
    if not audio.is_contiguous():
        raise ValueError("audio must be contiguous")
    bsz, n = audio.shape
    if bsz > _MAX_BATCH or n >= 2**31:
        raise ValueError(f"audio shape {tuple(audio.shape)} exceeds the kernel's limits")
    t = C.num_frames(n, hop)
    out = torch.empty((bsz, t, C.NUM_CHANNELS), dtype=torch.float32, device=audio.device)
    if t == 0 or bsz == 0:
        return out
    lib = _library()
    wc, ws, mel, _ = plain._device_constants(audio.device)  # [480, 257] x2, [257, 40]
    sf = torch.empty_like(out)
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mww_frontend_filterbank(
            audio.data_ptr(), int(audio.dtype == torch.float32), bsz, n, t, hop,
            wc.data_ptr(), ws.data_ptr(), mel.data_ptr(), sf.data_ptr(), stream,
        )
        _check(lib, err, "A (filterbank)")
        frontend_batch.launches += 1
        err = lib.mww_frontend_agc(sf.data_ptr(), out.data_ptr(), bsz, t, stream)
        _check(lib, err, "B (EMA + AGC)")
        frontend_batch.launches += 1
    return out


frontend_batch.launches = 0
