"""ctypes binding of the C++ streaming runtime (``native/src/mww_runtime.cc``).

The runtime runs an exported ``.mww`` model (``export/native_runtime.py``,
``export/native_quant.py``) one streaming step at a time on the host CPU,
with its own float port of the micro-frontend: the deployment target's
stand-in, with no Python and no PyTorch at run time.  The library is built
from the repo's source by ``g++`` at first use (``_build.build_runtime``)
into ``_build/``; nothing loads a prebuilt copy.  The WAV decoder, resampler
and VAD of ``native/src/mww_native.cc`` are not bound here: ``audio/`` keeps
its SciPy and NumPy paths.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from microwakeword_tpu_torch import _build

_i64 = ctypes.c_int64
_f32p = ctypes.POINTER(ctypes.c_float)
_i16p = ctypes.POINTER(ctypes.c_int16)
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


@functools.lru_cache(maxsize=None)
def runtime_lib() -> ctypes.CDLL:
    """The runtime library, built if needed, with every entry point typed."""
    lib = _build.load_runtime()
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


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
