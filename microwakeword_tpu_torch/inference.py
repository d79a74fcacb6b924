"""Streaming wake-word inference on raw audio (port of inference.py:25-92).

The PyTorch backend: features from the port's ``frontend_batch`` (the CUDA
kernel on the card) and the streaming model's ring-buffer scan, both on the
model's device.  The TFLite, native and StableHLO loaders wait for the
export slice.
"""

from __future__ import annotations

import numpy as np
import torch

from microwakeword_tpu_torch.device import resolve_device
from microwakeword_tpu_torch.frontend import frontend_batch


class Model:
    """Wake-word model for clip and spectrogram prediction.

    Usage: ``Model.from_torch(bundle, state)`` with ``state`` a state dict
    (for example ``models.convert.flax_to_state(variables)``).
    """

    def __init__(self, bundle, module: torch.nn.Module, device: torch.device):
        self.bundle = bundle
        self.module = module
        self.device = device
        self.stride = bundle.stride

    @classmethod
    def from_torch(cls, bundle, state: dict, device=None) -> "Model":
        dev = resolve_device(device)
        return cls(bundle, bundle.load(state, dev), dev)

    def _scan(self, spec: torch.Tensor) -> np.ndarray:
        t = (spec.shape[0] // self.stride) * self.stride
        if t <= 0:
            return np.zeros((0,), np.float32)
        probs = self.bundle.stream_scan(self.module, spec[None, :t])
        return probs.reshape(-1).cpu().numpy()

    @torch.inference_mode()
    def predict_spectrogram(self, spectrogram) -> np.ndarray:
        """[T, 40] features -> [T // stride] wake probabilities."""
        spec = torch.from_numpy(np.array(spectrogram, dtype=np.float32))
        return self._scan(spec.to(self.device))

    @torch.inference_mode()
    def predict_clip(self, audio, step_ms: int = 10) -> np.ndarray:
        """Raw 16 kHz PCM (int16, or float in [-1, 1]) -> probabilities."""
        audio = np.array(audio)
        if audio.dtype.kind == "f":
            audio = audio.astype(np.float32)
        pcm = torch.from_numpy(audio).to(self.device).reshape(1, -1)
        return self._scan(frontend_batch(pcm, step_ms=step_ms)[0])
