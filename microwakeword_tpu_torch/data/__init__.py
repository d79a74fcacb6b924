"""Spectrogram feature store and on-device batch sampling."""

from microwakeword_tpu_torch.data.ragged_store import RaggedSpectrogramStore  # noqa: F401
from microwakeword_tpu_torch.data.store import FeatureHandler  # noqa: F401
