"""Offline audio pipeline (port of ``microwakeword_tpu/audio``): clip
loading, augmentation, VAD, spectrograms.  NumPy and SciPy, except
``SpectrogramGeneration``, whose default frontend is the port's
``frontend_batch`` on a torch device."""

from microwakeword_tpu_torch.audio.augmentation import Augmentation  # noqa: F401
from microwakeword_tpu_torch.audio.clips import Clips  # noqa: F401
from microwakeword_tpu_torch.audio.spectrograms import SpectrogramGeneration  # noqa: F401
