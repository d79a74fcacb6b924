"""Streaming wake-word inference on raw audio (port of inference.py:25-92).

Four backends behind one ``Model``:

- ``from_torch``: the streaming model's ring-buffer scan on the model's
  device;
- ``from_exported``: a ``.mwwt`` artifact (``export/torch_export.py``), the
  serialized ``torch.export`` programs on the caller's device, the
  counterpart of the JAX package's ``from_stablehlo``;
- ``from_native``: the C++ streaming runtime on an exported ``.mww`` file,
  on the host CPU;
- ``from_tflite``: an exported ``.tflite`` file in the TFLite interpreter,
  on the host CPU (the reference's deployment artifact).

Features come from the port's ``frontend_batch`` on ``device`` (the CUDA
kernel on the card) for all four; ``predict_clip`` first truncates float
PCM to int16 as the JAX package's per-clip frontend does
(``frontend.plain.float_pcm_to_int16``).
"""

from __future__ import annotations

import numpy as np
import torch

from microwakeword_tpu_torch.device import resolve_device
from microwakeword_tpu_torch.frontend import frontend_batch
from microwakeword_tpu_torch.frontend.plain import float_pcm_to_int16
from microwakeword_tpu_torch.trace import span


class Model:
    """Wake-word model for clip and spectrogram prediction.

    Usage: ``Model.from_torch(bundle, state)`` with ``state`` a state dict
    (for example ``models.convert.flax_to_state(variables)``),
    ``Model.from_exported("model.mwwt")``, ``Model.from_native("model.mww")``
    or ``Model.from_tflite("stream_state_internal_quant.tflite", stride=3)``.
    """

    def __init__(self, predict_spectrogram_fn, stride: int, device: torch.device,
                 bundle=None, module: torch.nn.Module | None = None):
        self._predict = predict_spectrogram_fn
        self.stride = stride
        self.device = device
        self.bundle = bundle
        self.module = module

    @classmethod
    def from_torch(cls, bundle, state: dict, device=None) -> "Model":
        dev = resolve_device(device)
        module = bundle.load(state, dev)

        def predict(spec: torch.Tensor) -> np.ndarray:
            t = (spec.shape[0] // bundle.stride) * bundle.stride
            if t <= 0:
                return np.zeros((0,), np.float32)
            probs = bundle.stream_scan(module, spec[None, :t].to(dev))
            with span("predict.copy_out"):
                return probs.reshape(-1).cpu().numpy()

        return cls(predict, bundle.stride, dev, bundle, module)

    @classmethod
    def from_native(cls, path: str, step_ms: int = 10, device=None) -> "Model":
        """An exported ``.mww`` model in the C++ streaming runtime; ``device``
        runs the frontend of ``predict_clip``."""
        from microwakeword_tpu_torch.native import StreamingRuntime

        dev = resolve_device(device)
        runner = StreamingRuntime(path, step_ms=step_ms)

        def predict(spec: torch.Tensor) -> np.ndarray:
            runner.reset()
            return runner.predict_spectrogram(spec.cpu().numpy())

        return cls(predict, runner.stride, dev)

    @classmethod
    def from_exported(cls, path: str, device=None) -> "Model":
        """A ``.mwwt`` artifact (``export/torch_export.py``): its programs
        and the frontend of ``predict_clip`` run on ``device``."""
        from microwakeword_tpu_torch.export.torch_export import ExportedModel

        runner = ExportedModel(path, device)
        return cls(runner.predict_spectrogram, runner.stride, runner.device)

    @classmethod
    def from_tflite(cls, path: str, stride: int = 1, device=None) -> "Model":
        """An exported ``.tflite`` file in the TFLite interpreter on the
        host; ``device`` runs the frontend of ``predict_clip``."""
        from microwakeword_tpu_torch.export.tflite import TFLiteStreamingModel

        dev = resolve_device(device)
        runner = TFLiteStreamingModel(path, stride=stride)

        def predict(spec: torch.Tensor) -> np.ndarray:
            runner.reset()
            return runner.predict_spectrogram(spec.cpu().numpy())

        return cls(predict, stride, dev)

    @torch.inference_mode()
    def predict_spectrogram(self, spectrogram) -> np.ndarray:
        """[T, 40] features -> [T // stride] wake probabilities."""
        return self._predict(torch.from_numpy(np.array(spectrogram, dtype=np.float32)))

    @torch.inference_mode()
    def predict_clip(self, audio, step_ms: int = 10) -> np.ndarray:
        """Raw 16 kHz PCM (int16, or float in [-1, 1], truncated to int16 by
        ``float_pcm_to_int16``) -> probabilities.  Under a torch profiler the
        request is a ``predict.clip`` span holding ``predict.copy_in``,
        ``frontend.batch`` and the backend's spans (``trace.py``)."""
        with span("predict.clip"):
            with span("predict.copy_in"):
                audio = np.array(audio)
                if audio.dtype.kind == "f":
                    audio = float_pcm_to_int16(audio)
                pcm = torch.from_numpy(audio).to(self.device).reshape(1, -1)
            return self._predict(frontend_batch(pcm, step_ms=step_ms)[0])
