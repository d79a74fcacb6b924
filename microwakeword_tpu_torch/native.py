"""ctypes bindings of the repo's two C++ libraries (port of
``microwakeword_tpu/native.py``).

- The streaming runtime (``native/src/mww_runtime.cc``) runs an exported
  ``.mww`` model (``export/native_runtime.py``, ``export/native_quant.py``)
  one streaming step at a time on the host CPU, with its own float port of
  the micro-frontend: the deployment target's stand-in, with no Python and
  no PyTorch at run time (``StreamingRuntime``).
- The host I/O library (``native/src/mww_native.cc``): the threaded window
  gather of a ragged store, the WAV decoder and writer, the polyphase
  resampler and the energy VAD (``gather_windows``, ``wav_read_mono_f32``,
  ``wav_write_16k_i16``, ``resample_poly``, ``remove_silence_f32``), which
  ``data/store.py``, ``audio/io.py`` and ``audio/vad.py`` call as the JAX
  package does.  Their NumPy and SciPy counterparts stay beside them as
  the plain versions the tests compare against.

Both are built from the repo's sources by ``g++`` at first use
(``_build.build_runtime``, ``_build.build_native``) into ``_build/``;
nothing loads a prebuilt copy.  Without ``g++`` the first call raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from microwakeword_tpu_torch import _build

_i64 = ctypes.c_int64
_i32 = ctypes.c_int32
_f32p = ctypes.POINTER(ctypes.c_float)
_i16p = ctypes.POINTER(ctypes.c_int16)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_ptr = ctypes.c_void_p

# name: (argtypes, restype)
_SIGNATURES = {
    "mww_model_load": ([ctypes.c_char_p], _ptr),
    "mww_model_free": ([_ptr], None),
    "mww_model_stride": ([_ptr], ctypes.c_int),
    "mww_model_input_features": ([_ptr], ctypes.c_int),
    "mww_model_reset": ([_ptr], None),
    "mww_model_step": ([_ptr, _f32p], ctypes.c_float),
    "mww_model_predict_spectrogram": ([_ptr, _f32p, _i64, _f32p], _i64),
    "mww_frontend_create": ([ctypes.c_int], _ptr),
    "mww_frontend_free": ([_ptr], None),
    "mww_frontend_reset": ([_ptr], None),
    "mww_frontend_process_clip": ([_ptr, _i16p, _i64, _f32p], _i64),
    "mww_predict_clip": ([_ptr, _ptr, _i16p, _i64, _f32p], _i64),
}


# the host I/O library's entry points
_NATIVE_SIGNATURES = {
    "mww_gather_windows": ([_u16p, _i64p, _i64, ctypes.c_int, _i32p, _i32p, _i64, ctypes.c_int,
                            ctypes.c_float, _f32p, ctypes.c_int], None),
    "mww_wav_info": ([ctypes.c_char_p, _i32p, _i32p, _i32p, _i64p, _i32p], ctypes.c_int),
    "mww_wav_read_mono_f32": ([ctypes.c_char_p, _f32p, _i64], _i64),
    "mww_wav_write_16k_i16": ([ctypes.c_char_p, _i16p, _i64, ctypes.c_int], ctypes.c_int),
    "mww_resample_len": ([_i64, ctypes.c_int, ctypes.c_int], _i64),
    "mww_resample_poly": ([_f32p, _i64, ctypes.c_int, ctypes.c_int, _f32p], None),
    "mww_remove_silence_f32": ([_f32p, _i64, ctypes.c_int, _i64, ctypes.c_double, _f32p], _i64),
}


def _typed(lib: ctypes.CDLL, signatures: dict) -> ctypes.CDLL:
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


@functools.lru_cache(maxsize=None)
def runtime_lib() -> ctypes.CDLL:
    """The runtime library, built if needed, with every entry point typed."""
    return _typed(_build.load_runtime(), _SIGNATURES)


@functools.lru_cache(maxsize=None)
def native_lib() -> ctypes.CDLL:
    """The host I/O library, built if needed, with every entry point typed."""
    return _typed(_build.load_native(), _NATIVE_SIGNATURES)


# ---- host I/O (native/src/mww_native.cc) -------------------------------------


def gather_windows(data: np.ndarray, offsets: np.ndarray, clip_idx: np.ndarray,
                   starts: np.ndarray, length: int, scale: float = 0.0390625,
                   n_threads: int = 0) -> np.ndarray:
    """[B, length, F] float32 windows of a ragged uint16 store ``data``
    ([total_frames, F], may be a memmap; ``offsets`` [n_clips + 1]), scaled by
    ``scale`` and zero outside each clip; ``starts`` are relative to the clip,
    negative for left padding.  ``n_threads`` 0 uses every core."""
    data = np.ascontiguousarray(data, dtype=np.uint16)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    clip_idx = np.ascontiguousarray(clip_idx, dtype=np.int32)
    starts = np.ascontiguousarray(starts, dtype=np.int32)
    out = np.empty((len(clip_idx), length, data.shape[1]), np.float32)
    native_lib().mww_gather_windows(
        data.ctypes.data_as(_u16p), offsets.ctypes.data_as(_i64p), _i64(len(offsets) - 1),
        int(data.shape[1]), clip_idx.ctypes.data_as(_i32p), starts.ctypes.data_as(_i32p),
        _i64(len(clip_idx)), int(length), ctypes.c_float(scale), out.ctypes.data_as(_f32p),
        int(n_threads))
    return out


def wav_read_mono_f32(path: str) -> tuple[np.ndarray, int]:
    """Decodes a WAV file (PCM 8/16/24/32-bit or float32) to mono float32
    (the mean of its channels); returns (samples, sample rate).  Raises
    ValueError for a file the decoder does not read, float64 and 64-bit PCM
    included (the JAX binding lets those through as zeros)."""
    lib = native_lib()
    rate, channels, bits, is_float = _i32(0), _i32(0), _i32(0), _i32(0)
    n_frames = _i64(0)
    rc = lib.mww_wav_info(str(path).encode(), ctypes.byref(rate), ctypes.byref(channels),
                          ctypes.byref(bits), ctypes.byref(n_frames), ctypes.byref(is_float))
    if rc != 0:
        raise ValueError(f"unsupported or unreadable wav: {path} (rc={rc})")
    if bits.value not in ((32,) if is_float.value else (8, 16, 24, 32)):
        # the decoder accepts these headers but writes zeros for their samples
        raise ValueError(f"unsupported wav sample format: {path} ({bits.value}-bit "
                         f"{'float' if is_float.value else 'PCM'})")
    out = np.empty(n_frames.value, np.float32)
    got = lib.mww_wav_read_mono_f32(str(path).encode(), out.ctypes.data_as(_f32p), n_frames)
    if got < 0:
        raise ValueError(f"wav decode failed: {path} (rc={got})")
    return out[: int(got)], rate.value


def wav_write_16k_i16(path: str, samples: np.ndarray, rate: int = 16000) -> None:
    """Writes int16 ``samples`` as a mono PCM WAV at ``rate``."""
    samples = np.ascontiguousarray(samples, dtype=np.int16)
    rc = native_lib().mww_wav_write_16k_i16(str(path).encode(), samples.ctypes.data_as(_i16p),
                                            _i64(len(samples)), int(rate))
    if rc != 0:
        raise OSError(f"wav write failed: {path}")


def resample_poly(x: np.ndarray, up: int, down: int) -> np.ndarray:
    """Rational resampling by ``up / down`` with scipy.signal.resample_poly's
    filter (Kaiser window, beta 5, half length 10 * max(up, down)),
    accumulated in float64; float32 out."""
    lib = native_lib()
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(int(lib.mww_resample_len(_i64(len(x)), int(up), int(down))), np.float32)
    lib.mww_resample_poly(x.ctypes.data_as(_f32p), _i64(len(x)), int(up), int(down),
                          out.ctypes.data_as(_f32p))
    return out


def remove_silence_f32(x: np.ndarray, step: int, min_start: int,
                       threshold_ratio: float) -> np.ndarray:
    """The energy VAD of ``audio/vad.remove_silence`` on float32 samples:
    the first ``min_start`` samples, then the voiced ``step``-sample frames."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(len(x), np.float32)
    n = native_lib().mww_remove_silence_f32(x.ctypes.data_as(_f32p), _i64(len(x)), int(step),
                                            _i64(min_start), ctypes.c_double(threshold_ratio),
                                            out.ctypes.data_as(_f32p))
    return out[: int(n)].copy()


# ---- the streaming runtime (native/src/mww_runtime.cc) -----------------------


def _n_frames(samples: int, step_ms: int) -> int:
    return max(0, 1 + (samples - 480) // (16 * step_ms))


class StreamingRuntime:
    """A loaded ``.mww`` model and a frontend in the C++ runtime (port of
    ``microwakeword_tpu/native.py``'s class of the same name).

    ``predict_spectrogram`` streams [T, 40] features, ``predict_clip`` PCM
    through the runtime's own frontend at ``step_ms`` hops; both carry the
    ring buffers over calls until ``reset``.
    """

    def __init__(self, model_path: str, step_ms: int = 10):
        lib = runtime_lib()
        self._lib = lib
        self._model = lib.mww_model_load(str(model_path).encode())
        if not self._model:
            raise ValueError(f"cannot load native model: {model_path}")
        self._frontend = lib.mww_frontend_create(step_ms)
        self.stride = lib.mww_model_stride(self._model)
        self.input_features = lib.mww_model_input_features(self._model)
        self.step_ms = step_ms

    def __del__(self):  # pragma: no cover - destructor timing
        lib = getattr(self, "_lib", None)
        if lib is not None:
            if getattr(self, "_model", None):
                lib.mww_model_free(self._model)
            if getattr(self, "_frontend", None):
                lib.mww_frontend_free(self._frontend)

    def reset(self) -> None:
        self._lib.mww_model_reset(self._model)
        self._lib.mww_frontend_reset(self._frontend)

    def predict_spectrogram(self, spectrogram: np.ndarray) -> np.ndarray:
        """[T, input_features] float features -> [T // stride] probabilities."""
        spec = np.ascontiguousarray(spectrogram, dtype=np.float32)
        if spec.ndim != 2 or spec.shape[1] != self.input_features:
            raise ValueError(f"spectrogram {spec.shape}: want [T, {self.input_features}]")
        probs = np.empty(spec.shape[0] // self.stride, np.float32)
        got = self._lib.mww_model_predict_spectrogram(
            self._model, spec.ctypes.data_as(_f32p), _i64(spec.shape[0]),
            probs.ctypes.data_as(_f32p))
        return probs[: int(got)]

    @staticmethod
    def _pcm(pcm: np.ndarray) -> np.ndarray:
        if pcm.dtype in (np.float32, np.float64):
            pcm = np.clip(pcm * 32768, -32768, 32767).astype(np.int16)
        return np.ascontiguousarray(pcm, dtype=np.int16).reshape(-1)

    def predict_clip(self, pcm: np.ndarray) -> np.ndarray:
        """int16 (or float in [-1, 1]) 16 kHz PCM -> streaming probabilities."""
        pcm = self._pcm(pcm)
        probs = np.empty(max(_n_frames(len(pcm), self.step_ms) // self.stride, 1), np.float32)
        got = self._lib.mww_predict_clip(
            self._frontend, self._model, pcm.ctypes.data_as(_i16p), _i64(len(pcm)),
            probs.ctypes.data_as(_f32p))
        return probs[: int(got)]

    def process_features(self, pcm: np.ndarray) -> np.ndarray:
        """int16 PCM -> [n_frames, 40] float32 features (the runtime's frontend)."""
        pcm = self._pcm(pcm)
        out = np.empty((_n_frames(len(pcm), self.step_ms), 40), np.float32)
        got = self._lib.mww_frontend_process_clip(
            self._frontend, pcm.ctypes.data_as(_i16p), _i64(len(pcm)), out.ctypes.data_as(_f32p))
        return out[: int(got)]
