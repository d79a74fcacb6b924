"""Spectrogram generation from (augmented) audio clips (port of
``microwakeword_tpu/audio/spectrograms.py``, a rebuild of reference
audio/spectrograms.py:23-113).

The default frontend is the port's ``frontend.kernel.frontend_batch`` on
``device`` (None: the card): the CUDA kernel on the card, its plain version
on the CPU.  ``batched_spectrograms`` runs it over batches of clips, as the
dataset build and the clips-type sampler pool do.
"""

from __future__ import annotations

import numpy as np
import torch

from microwakeword_tpu_torch.audio.augmentation import Augmentation
from microwakeword_tpu_torch.audio.clips import Clips
from microwakeword_tpu_torch.device import resolve_device
from microwakeword_tpu_torch.frontend import constants as C
from microwakeword_tpu_torch.frontend.kernel import frontend_batch
from microwakeword_tpu_torch.frontend.plain import float_pcm_to_int16


def features_to_uint16(spec: np.ndarray) -> np.ndarray:
    """Features in [0, 26] -> the uint16 values a store holds."""
    return np.round(spec / C.FEATURE_SCALE).astype(np.uint16)


class SpectrogramGeneration:
    """Generates (augmented) spectrograms; optionally splits long ones into
    non-overlapping segments or yields ``slide_frames`` shifted copies to
    simulate streaming alignment (reference spectrograms.py:87-111)."""

    def __init__(
        self,
        clips: Clips,
        augmenter: Augmentation | None = None,
        step_ms: int = 10,
        split_spectrogram_duration_s: float | None = None,
        slide_frames: int | None = None,
        device=None,
    ):
        self.clips = clips
        self.augmenter = augmenter
        self.step_ms = step_ms
        self.split_spectrogram_duration_s = split_spectrogram_duration_s
        self.slide_frames = slide_frames
        self.device = device

    def frontend(self, audio: np.ndarray) -> np.ndarray:
        """One clip through ``frontend_batch`` on ``self.device``; float PCM
        is first truncated to int16 (``float_pcm_to_int16``), as the JAX
        package's default per-clip frontend converts it."""
        audio = np.asarray(audio)
        if audio.dtype.kind == "f":
            audio = float_pcm_to_int16(audio)
        x = torch.from_numpy(audio).to(resolve_device(self.device))
        return frontend_batch(x[None], self.step_ms)[0].cpu().numpy()

    def postprocess(self, spectrogram: np.ndarray):
        """Applies the configured split/slide expansion to one spectrogram,
        yielding the training-pool views (reference spectrograms.py:87-111)."""
        if self.split_spectrogram_duration_s is not None:
            length = int(self.split_spectrogram_duration_s / (self.step_ms / 1000))
            if spectrogram.shape[0] > length + 20:
                for start in range(20, spectrogram.shape[0] - length + 1, length):
                    yield spectrogram[start : start + length]
            else:
                yield spectrogram
        elif self.slide_frames is not None:
            window = spectrogram.shape[0] - self.slide_frames + 1
            for i in range(self.slide_frames):
                yield spectrogram[i : i + window]
        else:
            yield spectrogram

    def spectrogram_generator(self, random: bool = False, **kwargs):
        """Spectrograms of the (augmented) clips, through ``postprocess``:
        endlessly random clips, or ``Clips.audio_generator(**kwargs)``."""
        gen = self.clips.random_audio_generator() if random else self.clips.audio_generator(**kwargs)
        if self.augmenter is not None:
            gen = self.augmenter.augment_generator(gen)

        for clip in gen:
            yield from self.postprocess(self.frontend(clip))

    def batched_spectrograms(self, audio_gen, device=None, batch: int = 32):
        """uint16 spectrograms of the float [-1, 1] clips of ``audio_gen``,
        ``batch`` clips per ``frontend_batch`` call on ``device`` (None: the
        card), each through ``postprocess``.

        A batch is zero-padded to its longest clip.  Frame t of a clip reads
        samples [t * hop, t * hop + 480) only and the EMA runs forward in
        time, so the padding after a clip enters none of its frames (the JAX
        package pads to multiples of 8000 samples to bound its recompiles;
        eager torch has none).
        """
        dev = resolve_device(device)
        hop = C.hop_samples(self.step_ms)

        def flush(part):
            if not part:
                return
            x = np.zeros((len(part), max(max(len(c) for c in part), C.WINDOW_SAMPLES)), np.float32)
            for row, c in enumerate(part):
                x[row, : len(c)] = c
            feats = frontend_batch(torch.from_numpy(x).to(dev), self.step_ms).cpu().numpy()
            for row, c in enumerate(part):
                for spec in self.postprocess(feats[row, : C.num_frames(len(c), hop)]):
                    yield features_to_uint16(spec)

        part = []
        for clip in audio_gen:
            part.append(np.asarray(clip, np.float32))
            if len(part) == batch:
                yield from flush(part)
                part = []
        yield from flush(part)
