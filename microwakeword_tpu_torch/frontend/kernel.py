"""The micro-frontend's CUDA kernel (``csrc/frontend.cu``) and its wrapper.

``frontend_batch`` has the signature of the TPU kernel's wrapper
(``microwakeword_tpu/frontend/pallas.py:frontend_batch``): [B, N] int16 or
float PCM, ``step_ms`` 10 or 20 -> [B, T, 40] float32 features.  A CUDA
tensor launches the kernel or raises; a CPU tensor takes the plain version in
``frontend/plain.py``.  ``frontend_batch.launches`` counts the kernel launches,
``LAUNCHES_PER_CALL`` per call with frames:

- A (``stage_a``): per tile of ``TILE`` hops, a 512-point real FFT as a packed
  256-point complex one, energy, the mel filters' nonzero taps, sqrt / 8 ->
  the scaled filterbank, and the tile's local noise-estimate end (the EMA
  from zero over the tile);
- S (``stage_carry``): one thread per (row, channel) scans the row's tile
  ends with ``(1-s)^TILE`` into the estimate entering each tile, a chain of
  T / ``TILE`` steps;
- B (``stage_b``): one thread per (row, tile, 8 hops of the tile, channel)
  reads its tile's carry, carries it over the tile's earlier hops, then walks
  its 8 hops and applies the AGC.

A is bound by its instruction issue (FP32 operations, shared-memory and
shuffle traffic; registers cap it at 32 warps per SM), B by the IEEE
``powf`` and ``logf`` of the AGC and a serial chain of at most ``TILE``
steps, S by its launch.  ``host_tables`` holds the constants the kernel
reads, in float64; the kernel reports its layout (``TILE``, the shape of
``mel_slots``), and ``_library`` refuses a build whose layout differs.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from microwakeword_tpu_torch import _build
from microwakeword_tpu_torch.frontend import constants as C
from microwakeword_tpu_torch.frontend import plain
from microwakeword_tpu_torch.trace import span

TILE = 32  # hops per block of launch A and per EMA tile (kTile in csrc/frontend.cu)
_MEL_ROUNDS = 3  # mel channels per warp of launch A, at most (kMelRounds)
_WARPS_A = 16  # warps per block of launch A (kWarpsA)
LAUNCHES_PER_CALL = 3


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("frontend")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mww_frontend_error_string.argtypes = [i32]
    lib.mww_frontend_error_string.restype = ctypes.c_char_p
    lib.mww_frontend_layout.argtypes = [ctypes.POINTER(i32)] * 3
    lib.mww_frontend_layout.restype = None
    lib.mww_frontend_filterbank.argtypes = [ptr, i32, i32, i32, i32, i32] + [ptr] * 12
    lib.mww_frontend_filterbank.restype = i32
    lib.mww_frontend_carry_scan.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
    lib.mww_frontend_carry_scan.restype = i32
    lib.mww_frontend_ema_agc.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
    lib.mww_frontend_ema_agc.restype = i32
    layout = [i32() for _ in range(3)]
    lib.mww_frontend_layout(*layout)
    got = tuple(v.value for v in layout)
    if got != (TILE, _MEL_ROUNDS, _WARPS_A):
        raise RuntimeError(f"csrc/frontend.cu has (tile, mel rounds, warps of A) {got}, "
                           f"not {(TILE, _MEL_ROUNDS, _WARPS_A)}")
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.mww_frontend_error_string(err).decode()
        raise RuntimeError(f"frontend kernel {what} failed: cudaError {err} ({msg})")


def _complex_pairs(z: np.ndarray) -> np.ndarray:
    """Complex -> [..., 2] (re, im) float64, the kernel's float2 layout."""
    return np.stack([z.real, z.imag], axis=-1)


@functools.lru_cache(maxsize=None)
def host_tables() -> dict[str, np.ndarray]:
    """The constants the kernel reads, computed in float64 (int32 for indices).

    - ``window`` [480]: the Hann window;
    - ``fft16`` [3]: cos(pi/8), sin(pi/8), cos(pi/4), the 16-point FFT's twiddles;
    - ``tw256`` [16, 16, 2]: W256^(n2 k1) at [k1, n2], between the FFT's passes;
    - ``tw512`` [257, 2]: W512^k, the split step's twiddles;
    - ``mel_first`` [40], ``mel_offset`` [41], ``mel_weights`` [taps]: each
      channel's weights over bins ``mel_first[c]`` onwards, stored at
      ``mel_weights[mel_offset[c]:mel_offset[c + 1]]`` in ascending bin order,
      float32-rounded as in the plain version's dense matrix;
    - ``mel_slots`` [3, 16]: the channel that warp w of launch A's 16 takes
      in round r (at most 3 channels a warp), or -1: the largest channels first, each to the
      least-loaded warp, so that no warp sums more than 29 of the 456 taps;
    - ``ema_powers`` [2, TILE]: (1 - s)^m, m < TILE, for even and odd
      channels, the weights of a tile's local EMA end;
    - ``decay`` [2]: (1 - s)^TILE, the carry from one tile to the next.

    W_N = exp(-2 pi i / N).  ``device_tables`` casts the floats to float32.
    """
    k1, n2 = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    mel = C.mel_filterbank_matrix().astype(np.float32).astype(np.float64)
    first, offset, weights = [], [0], []
    for c in range(C.NUM_CHANNELS):
        nz = np.flatnonzero(mel[:, c])
        first.append(nz[0])
        weights.append(mel[nz[0] : nz[-1] + 1, c])
        offset.append(offset[-1] + nz[-1] + 1 - nz[0])
    taps = np.diff(offset)
    load, slots = [0] * _WARPS_A, np.full((_MEL_ROUNDS, _WARPS_A), -1, np.int32)
    for c in np.argsort(-taps, kind="stable"):
        j = min((n, j) for j, n in enumerate(load) if slots[-1, j] < 0)[1]
        slots[np.argmax(slots[:, j] < 0), j] = c
        load[j] += taps[c]
    smoothing = np.array([C.EVEN_SMOOTHING, C.ODD_SMOOTHING], np.float64)
    return {
        "window": C.hann_window(),
        "fft16": np.array([np.cos(np.pi / 8), np.sin(np.pi / 8), np.cos(np.pi / 4)]),
        "tw256": _complex_pairs(np.exp(-2j * np.pi * k1 * n2 / 256)),
        "tw512": _complex_pairs(np.exp(-2j * np.pi * np.arange(C.N_FFT_BINS) / C.FFT_SIZE)),
        "mel_first": np.array(first, np.int32),
        "mel_offset": np.array(offset, np.int32),
        "mel_weights": np.concatenate(weights),
        "mel_slots": slots,
        "ema_powers": (1.0 - smoothing[:, None]) ** np.arange(TILE),
        "decay": (1.0 - smoothing) ** TILE,
    }


@functools.lru_cache(maxsize=None)
def device_tables(device: torch.device) -> dict[str, torch.Tensor]:
    """``host_tables`` on ``device``: floats cast to float32, indices int32."""
    return {
        k: torch.from_numpy(v if v.dtype == np.int32 else v.astype(np.float32)).to(device)
        for k, v in host_tables().items()
    }


def _hop_and_frames(audio: torch.Tensor, step_ms: int) -> tuple[int, int]:
    """Checks a CUDA audio tensor for launch A; returns (hop, T)."""
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
    t = C.num_frames(n, hop)
    if n >= 2**31 or bsz * -(-t // TILE) * TILE * C.NUM_CHANNELS >= 2**31:
        raise ValueError(f"audio shape {tuple(audio.shape)} exceeds the kernel's limits")
    return hop, t


def stage_a(audio: torch.Tensor, step_ms: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch A alone (CUDA tensors only): [B, N] PCM -> (scaled filterbank
    [B, T, 40], tile ends [B, ceil(T / TILE), 40]), both float32."""
    hop, t = _hop_and_frames(audio, step_ms)
    bsz, n = audio.shape
    sf = torch.empty((bsz, t, C.NUM_CHANNELS), dtype=torch.float32, device=audio.device)
    ends = sf.new_empty((bsz, -(-t // TILE), C.NUM_CHANNELS))
    if t == 0 or bsz == 0:
        return sf, ends
    lib = _library()
    tab = device_tables(audio.device)
    with torch.cuda.device(audio.device):
        err = lib.mww_frontend_filterbank(
            audio.data_ptr(), int(audio.dtype == torch.float32), bsz, n, t, hop,
            *(tab[k].data_ptr() for k in (
                "window", "fft16", "tw256", "tw512", "mel_first", "mel_offset", "mel_weights",
                "mel_slots", "ema_powers")),
            sf.data_ptr(), ends.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _check(lib, err, "A (filterbank)")
    frontend_batch.launches += 1
    return sf, ends


def stage_carry(ends: torch.Tensor) -> torch.Tensor:
    """Launch S alone (CUDA tensors only): ``stage_a``'s tile ends -> the
    estimate entering each tile [B, ceil(T / TILE), 40]."""
    carries = torch.empty_like(ends)
    bsz, n_tiles, _ = ends.shape
    if n_tiles == 0 or bsz == 0:
        return carries
    lib = _library()
    decay = device_tables(ends.device)["decay"]
    with torch.cuda.device(ends.device):
        err = lib.mww_frontend_carry_scan(
            ends.data_ptr(), decay.data_ptr(), carries.data_ptr(), bsz, n_tiles,
            torch.cuda.current_stream().cuda_stream,
        )
    _check(lib, err, "S (carry scan)")
    frontend_batch.launches += 1
    return carries


def stage_b(sf: torch.Tensor, carries: torch.Tensor) -> torch.Tensor:
    """Launch B alone (CUDA tensors only): ``stage_a``'s scaled filterbank and
    ``stage_carry``'s carries -> [B, T, 40] features."""
    out = torch.empty_like(sf)
    bsz, t, _ = sf.shape
    if t == 0 or bsz == 0:
        return out
    lib = _library()
    with torch.cuda.device(sf.device):
        err = lib.mww_frontend_ema_agc(
            sf.data_ptr(), carries.data_ptr(), out.data_ptr(), bsz, t,
            torch.cuda.current_stream().cuda_stream,
        )
    _check(lib, err, "B (EMA + AGC)")
    frontend_batch.launches += 1
    return out


def frontend_batch(audio: torch.Tensor, step_ms: int = 10) -> torch.Tensor:
    """[B, N] int16/float32 samples -> [B, T, 40] float32 features in [0, 26].

    T = 1 + (N - 480) // hop, and 0 when N < 480 (no launch then).  Under a
    torch profiler the call is a ``frontend.batch`` span (``trace.py``).
    """
    if not isinstance(audio, torch.Tensor):
        raise TypeError(f"audio must be a torch.Tensor, got {type(audio).__name__}")
    with span("frontend.batch"):
        if audio.device.type == "cpu":
            return plain.frontend_batch(audio, step_ms)
        sf, ends = stage_a(audio, step_ms)
        return stage_b(sf, stage_carry(ends))


frontend_batch.launches = 0
