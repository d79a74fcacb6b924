"""Audio file IO: decode to 16 kHz mono float32 (-1..1) (port of
``microwakeword_tpu/audio/io.py``).

WAV files go through the native decoder and resampler
(``native/src/mww_native.cc``, bound in ``native.py``), as in the JAX package;
a WAV codec that decoder does not read (ADPCM, for one) goes to scipy, the
reference's format rule.  Other formats fall back to HF ``datasets``
(soundfile/soxr) when installed.  ``load_audio_plain`` is the scipy version
of the WAV path, which the tests hold the native one against.
"""

from __future__ import annotations

import os
import wave
from math import gcd

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from microwakeword_tpu_torch import native

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
    try:
        data, rate = native.wav_read_mono_f32(path)
    except ValueError:  # a codec the native decoder does not read
        return load_audio_plain(path, target_rate)
    if rate != target_rate:
        g = gcd(rate, target_rate)
        data = native.resample_poly(data, target_rate // g, rate // g)
    return data


def load_audio_plain(path: str, target_rate: int = SAMPLE_RATE) -> np.ndarray:
    """A WAV file as 16 kHz mono float32 through scipy: decode, channel mean,
    ``scipy.signal.resample_poly``."""
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
