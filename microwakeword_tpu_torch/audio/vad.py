"""Voice-activity-based silence trimming (port of
``microwakeword_tpu/audio/vad.py``).

The reference uses webrtcvad (C++) at its least aggressive setting to trim
silence during data prep (audio_utils.py:99-140).  This is an adaptive-energy
VAD with the same interface and frame semantics (30 ms frames, always keep the
first ``min_start`` samples, concatenate voiced frames), used only in offline
data prep.  ``remove_silence`` runs the native version
(``native/src/mww_native.cc``, in float32), as the JAX package does;
``remove_silence_plain`` is the NumPy one (float64), which the tests hold it
against.
"""

from __future__ import annotations

import numpy as np

from microwakeword_tpu_torch import native

NOISE_FLOOR_MULTIPLIER = 1.75  # see remove_silence docstring


def frame_energies(audio: np.ndarray, step: int) -> np.ndarray:
    """Per-frame RMS after removing each frame's DC offset."""
    n = (len(audio) // step) * step
    if n == 0:
        return np.zeros((0,))
    frames = audio[:n].reshape(-1, step).astype(np.float64)
    frames = frames - frames.mean(axis=1, keepdims=True)
    return np.sqrt((frames**2).mean(axis=1))


def remove_silence(
    audio_data: np.ndarray,
    frame_duration: float = 0.030,
    sample_rate: int = 16000,
    min_start: int = 2000,
    threshold_ratio: float = 0.1,
) -> np.ndarray:
    """Trims non-voice frames (interface of reference remove_silence_webrtc).

    A frame is voiced if its DC-removed RMS exceeds
    max(noise_floor * 1.75, threshold_ratio * 90th-percentile RMS), with
    noise_floor = the 10th-percentile frame RMS.  The multiplier is
    permissive, like webrtcvad.Vad(0): for white-ish noise the per-frame RMS
    concentrates within a few percent of the floor, so 1.75x rejects noise
    frames by a wide margin while keeping quiet speech down to ~5 dB over the
    floor; trimming voiced frames is the failure that matters for data prep,
    keeping extra noise frames is not.
    """
    float_type = audio_data.dtype in (np.float32, np.float64)
    audio = _as_float64(audio_data, float_type)
    out = native.remove_silence_f32(audio.astype(np.float32), int(sample_rate * frame_duration),
                                    min_start, threshold_ratio)
    if float_type:
        return out.astype(audio_data.dtype)
    return (out.astype(np.float64) * 32768.0).astype(np.int16)


def _as_float64(audio_data: np.ndarray, float_type: bool) -> np.ndarray:
    return audio_data.astype(np.float64) if float_type else audio_data.astype(np.float64) / 32768.0


def remove_silence_plain(
    audio_data: np.ndarray,
    frame_duration: float = 0.030,
    sample_rate: int = 16000,
    min_start: int = 2000,
    threshold_ratio: float = 0.1,
) -> np.ndarray:
    """``remove_silence`` in NumPy, in float64."""
    float_type = audio_data.dtype in (np.float32, np.float64)
    audio = _as_float64(audio_data, float_type)
    step = int(sample_rate * frame_duration)
    kept = [audio[:min_start]]
    if len(audio) > min_start + step:
        body = audio[min_start:]
        rms = frame_energies(body, step)
        if rms.size:
            noise_floor = np.percentile(rms, 10)
            thresh = max(
                noise_floor * NOISE_FLOOR_MULTIPLIER,
                threshold_ratio * np.percentile(rms, 90),
            )
            for i, r in enumerate(rms):
                if r > thresh:
                    kept.append(body[i * step : (i + 1) * step])
    out = np.concatenate(kept) if kept else audio[:0]
    if float_type:
        return out.astype(audio_data.dtype)
    return (out * 32768.0).astype(np.int16)
