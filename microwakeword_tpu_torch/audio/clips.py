"""Audio clip loading with duration filtering, set splitting, VAD trimming
and repetition (port of ``microwakeword_tpu/audio/clips.py``, itself a rebuild
of reference audio/clips.py:30-241)."""

from __future__ import annotations

import math
import os
import wave
from pathlib import Path

import numpy as np

from microwakeword_tpu_torch.audio.io import load_audio, wav_duration_seconds
from microwakeword_tpu_torch.audio.vad import remove_silence


class Clips:
    """Loads and serves audio clips from a directory (see reference
    clips.py:30-44 for the argument semantics)."""

    def __init__(
        self,
        input_directory: str,
        file_pattern: str | list[str] = "*.wav",
        min_clip_duration_s: float | None = None,
        max_clip_duration_s: float | None = None,
        repeat_clip_min_duration_s: float | None = None,
        remove_silence: bool = False,
        random_split_seed: int | None = None,
        split_count: int | float = 0.1,
        trimmed_clip_duration_s: float | None = None,
        trim_zeros: bool = False,
        seed: int | None = None,
    ):
        self.trim_zeros = trim_zeros
        self.trimmed_clip_duration_s = trimmed_clip_duration_s
        self.min_clip_duration_s = min_clip_duration_s or 0.0
        self.max_clip_duration_s = (
            max_clip_duration_s if max_clip_duration_s is not None else math.inf
        )
        self.repeat_clip_min_duration_s = repeat_clip_min_duration_s or 0.0
        self.remove_silence = remove_silence
        self.rng = np.random.default_rng(seed)

        patterns = [file_pattern] if isinstance(file_pattern, str) else file_pattern
        paths = []
        for pat in patterns:
            paths.extend(str(p) for p in Path(input_directory).glob(pat))
        paths.sort()

        if self.min_clip_duration_s > 0 or not math.isinf(self.max_clip_duration_s):
            paths = self._filter_by_duration(paths)

        self.clips = paths
        self.split_clips: dict[str, list[str]] | None = None
        if random_split_seed is not None:
            self.split_clips = self._split(paths, random_split_seed, split_count)

    # ------------------------------------------------------------------
    def _filter_by_duration(self, paths: list[str]) -> list[str]:
        if not paths:
            return paths
        out = []
        if paths[0].lower().endswith(".wav"):
            # size-based batch estimate assuming uniform parameters
            # (reference clips.py:88-118)
            with wave.open(paths[0], "rb") as f:
                params = (f.getnchannels(), f.getsampwidth(), f.getframerate(),
                          f.getnframes())
            header_correction = os.path.getsize(paths[0]) - (
                params[3] * params[1] * params[0]
            )
            for p in paths:
                d = wav_duration_seconds(p, header_correction, params)
                if self.min_clip_duration_s < d < self.max_clip_duration_s:
                    out.append(p)
        else:
            for p in paths:
                d = len(load_audio(p)) / 16000.0
                if self.min_clip_duration_s < d < self.max_clip_duration_s:
                    out.append(p)
        return out

    @staticmethod
    def _split(paths, seed, split_count):
        """train/test/validation split (reference clips.py:145-158: 2x
        split_count held out, halved into test and validation)."""
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(paths))
        if isinstance(split_count, float) and split_count < 1:
            held = int(round(2 * split_count * len(paths)))
        else:
            held = int(2 * split_count)
        held = min(held, len(paths))
        test_idx = idx[: held // 2]
        val_idx = idx[held // 2 : held]
        train_idx = idx[held:]
        return {
            "train": [paths[i] for i in sorted(train_idx)],
            "test": [paths[i] for i in sorted(test_idx)],
            "validation": [paths[i] for i in sorted(val_idx)],
        }

    # ------------------------------------------------------------------
    def _prepare(self, audio: np.ndarray) -> np.ndarray:
        if self.remove_silence:
            audio = remove_silence(audio)
        if self.trim_zeros:
            audio = np.trim_zeros(audio)
        if self.trimmed_clip_duration_s:
            audio = audio[: int(self.trimmed_clip_duration_s * 16000)]
        return self.repeat_clip(audio)

    def repeat_clip(self, audio: np.ndarray) -> np.ndarray:
        """Repeat until longer than repeat_clip_min_duration_s
        (reference clips.py:228-241)."""
        original = audio
        desired = int(self.repeat_clip_min_duration_s * 16000)
        while audio.shape[0] < desired:
            audio = np.append(audio, original)
        return audio

    def get_random_clip(self) -> np.ndarray:
        path = self.clips[int(self.rng.integers(len(self.clips)))]
        return self._prepare(load_audio(path))

    def audio_generator(self, split: str | None = None, repeat: int = 1):
        paths = self.clips if split is None else self.split_clips[split]
        for _ in range(repeat):
            for path in paths:
                yield self._prepare(load_audio(path))

    def random_audio_generator(self, max_clips: float = math.inf):
        while max_clips > 0:
            max_clips -= 1
            yield self.get_random_clip()
