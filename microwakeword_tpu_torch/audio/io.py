"""Audio file IO: decode to 16 kHz mono float32 (-1..1) (port of
``microwakeword_tpu/audio/io.py``).

WAV files are read with the stdlib/scipy stack, as the JAX package does when
its native decoder is not built; other formats fall back to HF ``datasets``
(soundfile/soxr) when installed.  The native WAV decoder and resampler
(``native/``) are not bound to the port.
"""

from __future__ import annotations

import os
import wave
from math import gcd

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

SAMPLE_RATE = 16000


def wav_duration_seconds(path: str, header_correction: int | None = None,
                         params: tuple | None = None) -> float:
    """Estimates a wav file's duration from its size (fast batch filtering,
    reference clips.py:88-118 / openWakeWord's estimate_clip_duration)."""
    if params is None:
        with wave.open(path, "rb") as f:
            params = (f.getnchannels(), f.getsampwidth(), f.getframerate(), f.getnframes())
    channels, width, rate, frames = params
    if header_correction is None:
        header_correction = os.path.getsize(path) - frames * width * channels
    return (os.path.getsize(path) - header_correction) / (rate * width * channels)


def load_audio(path: str, target_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Loads a supported audio file as 16 kHz mono float32 in [-1, 1]."""
    if not path.lower().endswith(".wav"):  # pragma: no cover - optional dependency path
        import datasets

        ds = datasets.Dataset.from_dict({"audio": [path]}).cast_column(
            "audio", datasets.Audio(sampling_rate=target_rate))
        return np.asarray(ds[0]["audio"]["array"], dtype=np.float32)
    rate, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if rate != target_rate:
        g = gcd(rate, target_rate)
        data = resample_poly(data, target_rate // g, rate // g).astype(np.float32)
    return np.asarray(data, dtype=np.float32)


def save_clip(audio_samples: np.ndarray, output_file: str) -> None:
    """Saves samples as a 16 kHz wav (reference audio_utils.py:87-96)."""
    if audio_samples.dtype in (np.float32, np.float64):
        audio_samples = (audio_samples * 32767).astype(np.int16)
    wavfile.write(output_file, SAMPLE_RATE, audio_samples)
