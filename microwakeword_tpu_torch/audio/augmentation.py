"""Clip augmentation pipeline (port of ``microwakeword_tpu/audio/augmentation.py``,
the reference audio/augmentation.py rebuilt on the DSP primitives of
``audio/dsp.py`` -- no audiomentations dependency).

Same composition, order and defaults as the reference (augmentation.py:43-162):
jitter pad -> fixed-size crop/left-pad -> [EQ, distortion, pitch shift,
band-stop, colored noise, background mix, gain, gain transition, RIR,
normalize-if-clipped], each applied with its configured probability.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np

from microwakeword_tpu_torch.audio import dsp
from microwakeword_tpu_torch.audio.io import load_audio

DEFAULT_PROBABILITIES = {
    "SevenBandParametricEQ": 0.0,
    "TanhDistortion": 0.0,
    "PitchShift": 0.0,
    "BandStopFilter": 0.0,
    "AddColorNoise": 0.25,
    "AddBackgroundNoise": 0.75,
    "Gain": 1.0,
    "GainTransition": 0.25,
    "RIR": 0.5,
}

AUDIO_PATTERNS = ("*.wav", "*.flac", "*.mp3", "*.ogg")


def _collect_audio_files(paths: List[str]) -> list[str]:
    files: list[str] = []
    for p in paths or []:
        root = Path(p)
        if root.is_file():
            files.append(str(root))
            continue
        for pat in AUDIO_PATTERNS:
            files.extend(str(f) for f in root.glob(f"**/{pat}"))
    return sorted(files)


class Augmentation:
    """Applies randomized augmentations to audio clips.

    Args mirror the reference class (augmentation.py:43-70)."""

    def __init__(
        self,
        augmentation_duration_s: float | None = None,
        augmentation_probabilities: dict = DEFAULT_PROBABILITIES,
        impulse_paths: List[str] | None = None,
        background_paths: List[str] | None = None,
        background_min_snr_db: float = -10,
        background_max_snr_db: float = 10,
        color_min_snr_db: float = 10,
        color_max_snr_db: float = 30,
        min_gain_db: float = -45,
        max_gain_db: float = 0,
        min_gain_transition_db: float = -10,
        max_gain_transition_db: float = 10,
        min_jitter_s: float = 0.0,
        max_jitter_s: float = 0.0,
        truncate_randomly: bool = False,
        seed: int | None = None,
    ):
        self.probabilities = dict(augmentation_probabilities)
        self.truncate_randomly = truncate_randomly
        self.min_jitter_samples = int(min_jitter_s * 16000)
        self.max_jitter_samples = int(max_jitter_s * 16000)
        if self.min_jitter_samples > self.max_jitter_samples:
            raise ValueError("min_jitter_s must be <= max_jitter_s")
        self.augmented_samples = (
            int(augmentation_duration_s * 16000)
            if augmentation_duration_s is not None
            else None
        )
        self.background_snr = (background_min_snr_db, background_max_snr_db)
        self.color_snr = (color_min_snr_db, color_max_snr_db)
        self.gain_range = (min_gain_db, max_gain_db)
        self.gain_transition_range = (min_gain_transition_db, max_gain_transition_db)
        self.impulse_files = _collect_audio_files(impulse_paths or [])
        self.background_files = _collect_audio_files(background_paths or [])
        if not self.background_files:
            self.probabilities["AddBackgroundNoise"] = 0.0
        if not self.impulse_files:
            self.probabilities["RIR"] = 0.0
        self.rng = np.random.default_rng(seed)
        self._bg_cache: dict[str, np.ndarray] = {}

    # ------------------------------------------------------------------
    def _load_cached(self, path: str) -> np.ndarray:
        if path not in self._bg_cache:
            if len(self._bg_cache) > 256:
                self._bg_cache.clear()
            self._bg_cache[path] = load_audio(path)
        return self._bg_cache[path]

    def add_jitter(self, audio: np.ndarray) -> np.ndarray:
        """Right-pad by a random jitter duration (reference :164-181)."""
        if self.min_jitter_samples < self.max_jitter_samples:
            jitter = int(
                self.rng.integers(self.min_jitter_samples, self.max_jitter_samples)
            )
        else:
            jitter = self.min_jitter_samples
        return np.pad(audio, (0, jitter))

    def create_fixed_size_clip(self, audio: np.ndarray) -> np.ndarray:
        """Crop (from start) or left-pad to the fixed duration (:183-212)."""
        if self.augmented_samples is None:
            return audio
        n = self.augmented_samples
        if n < audio.shape[0]:
            if self.truncate_randomly:
                start = int(self.rng.integers(0, audio.shape[0] - n))
                return audio[start : start + n]
            return audio[-n:]
        return np.pad(audio, (n - audio.shape[0], 0))

    def _p(self, name: str) -> bool:
        return self.rng.uniform() < self.probabilities.get(name, 0.0)

    def augment_clip(self, audio: np.ndarray) -> np.ndarray:
        audio = np.asarray(audio, dtype=np.float32)
        audio = self.add_jitter(audio)
        audio = self.create_fixed_size_clip(audio)
        rng = self.rng
        if self._p("SevenBandParametricEQ"):
            audio = dsp.seven_band_parametric_eq(audio, rng)
        if self._p("TanhDistortion"):
            audio = dsp.tanh_distortion(audio, rng)
        if self._p("PitchShift"):
            audio = dsp.pitch_shift(audio, rng)
        if self._p("BandStopFilter"):
            audio = dsp.band_stop_filter(audio, rng)
        if self._p("AddColorNoise"):
            audio = dsp.add_colored_noise(audio, rng, *self.color_snr)
        if self._p("AddBackgroundNoise"):
            bg = self._load_cached(
                self.background_files[int(rng.integers(len(self.background_files)))]
            )
            audio = dsp.add_background_noise(audio, bg, rng, *self.background_snr)
        if self._p("Gain"):
            audio = dsp.gain(audio, rng, *self.gain_range)
        if self._p("GainTransition"):
            audio = dsp.gain_transition(audio, rng, *self.gain_transition_range)
        if self._p("RIR"):
            ir = self._load_cached(
                self.impulse_files[int(rng.integers(len(self.impulse_files)))]
            )
            audio = dsp.apply_impulse_response(audio, ir)
        return dsp.normalize_if_clipped(audio)

    def augment_generator(self, audio_generator):
        for audio in audio_generator:
            yield self.augment_clip(audio)
